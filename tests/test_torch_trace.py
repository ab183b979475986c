"""The port's stack-distance trace tools (``data/trace.py``) against the JAX
package's: the same seeded numpy inputs give equal profiles, equal
distribution files byte for byte, equal traces from the numpy LRU loop
with its state carried across calls, and ``NativeLruTrace`` streams equal
bit for bit (both packages build the same C++ source)."""

import numpy as np
import pytest

from deeprecsys_tpu.data import trace as jax_trace
from deeprecsys_tpu.runtime.native import native_available as jax_native_available
from deeprecsys_tpu_torch.data import trace
from deeprecsys_tpu_torch.runtime.native import native_available


def _zipf_trace(seed, n=2000, lines=300, alpha=1.1):
    return np.mod(np.random.default_rng(seed).zipf(alpha, size=n), lines)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profile_and_distributions_equal_jax(seed):
    t = _zipf_trace(seed)
    got = trace.trace_profile(t)
    assert got == jax_trace.trace_profile(t)
    assert trace.compute_distributions(got[1]) == jax_trace.compute_distributions(got[1])


def test_trace_profile_simple():
    # a b a c b: distances 0, 0, 2, 0, 3; lines a, b, c
    assert trace.trace_profile([1, 2, 1, 3, 2]) == ([1, 2, 3], [0, 0, 2, 0, 3])


@pytest.mark.parametrize("lines,alpha,samples,seed", [(200, 1.05, 2000, 0),
                                                      (64, 1.3, 4000, 5)])
def test_synthesized_distribution_equals_jax(lines, alpha, samples, seed):
    assert trace.synthesize_zipf_distribution(lines, alpha, samples, seed) == \
        jax_trace.synthesize_zipf_distribution(lines, alpha, samples, seed)


@pytest.mark.parametrize("fmt", ["3line", "2line"])
def test_dist_files_byte_equal_and_read_back_equal(tmp_path, fmt):
    la, vals, cdf = trace.synthesize_zipf_distribution(300, num_samples=3000)
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    if fmt == "3line":
        trace.write_dist_file(got, la, vals, cdf)
        jax_trace.write_dist_file(want, la, vals, cdf)
    else:
        trace.write_dist_file_2line(got, vals, cdf)
        jax_trace.write_dist_file_2line(want, vals, cdf)
    assert got.read_bytes() == want.read_bytes()
    assert trace.read_dist_from_file(got) == jax_trace.read_dist_from_file(got)
    head = trace.read_dist_from_file(got)[0]
    assert (head is None) == (fmt == "2line")


@pytest.mark.parametrize("text", ["1, 2, 3, 2, 1\n", "5 6\n7\n\n8 5\n"])
def test_read_trace_file_equals_jax(tmp_path, text):
    p = tmp_path / "ids.txt"
    p.write_text(text)
    np.testing.assert_array_equal(trace.read_trace_file(p), jax_trace.read_trace_file(p))


@pytest.mark.parametrize("cdf", [[], [0.2, 0.1, 1.0], [0.1, 0.5, 0.9]])
def test_validate_cdf_errors_equal_jax(cdf):
    with pytest.raises(ValueError) as got:
        trace.validate_cdf(cdf, "f.txt")
    with pytest.raises(ValueError) as want:
        jax_trace.validate_cdf(cdf, "f.txt")
    assert str(got.value) == str(want.value)
    assert "sd_prob" in str(got.value)


def test_validate_cdf_accepts_a_cdf():
    trace.validate_cdf([0.25, 0.5, 1.0])


@pytest.mark.parametrize("size,seed", [(10, 0), (1000, 3)])
def test_random_line_accesses_equal_jax(size, seed):
    assert trace.random_line_accesses(size, np.random.default_rng(seed)) == \
        jax_trace.random_line_accesses(size, np.random.default_rng(seed))


@pytest.mark.parametrize("padding", [False, True])
def test_generate_stack_distance_equals_jax(padding):
    _, vals, cdf = trace.synthesize_zipf_distribution(100, num_samples=2000)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for i in (0, 1, 5, 50, 10_000):
        assert trace.generate_stack_distance(vals, cdf, vals[-1], i, r1, padding) == \
            jax_trace.generate_stack_distance(vals, cdf, vals[-1], i, r2, padding)


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("lengths", [(200,), (7, 50, 1, 120)])
def test_trace_generate_lru_with_state_carried_equals_jax(padding, lengths):
    """Successive calls continue one stream: the line order rotates in place
    and the introduced-lines counter is threaded through ``i_start``."""
    la, vals, cdf = trace.synthesize_zipf_distribution(150, num_samples=3000, seed=2)
    mine, theirs = list(la), list(la)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    i1 = i2 = 0
    for n in lengths:
        got, i1 = trace.trace_generate_lru(mine, vals, cdf, n, padding, rng=r1,
                                           i_start=i1, return_i=True)
        want, i2 = jax_trace.trace_generate_lru(theirs, vals, cdf, n, padding, rng=r2,
                                                i_start=i2, return_i=True)
        assert got == want and i1 == i2
        assert mine == theirs
    assert trace.trace_generate_lru(list(la), vals, cdf, 5, rng=np.random.default_rng(1)) == \
        jax_trace.trace_generate_lru(list(la), vals, cdf, 5, rng=np.random.default_rng(1))


@pytest.mark.skipif(not (native_available() and jax_native_available()),
                    reason="the native runtime does not build here")
@pytest.mark.parametrize("seed,padding", [(0, False), (12345, False), (7, True)])
def test_native_lru_trace_equals_jax(seed, padding):
    la, vals, cdf = trace.synthesize_zipf_distribution(500, num_samples=5000, seed=seed)
    got = trace.NativeLruTrace(la, vals, cdf, seed=seed, enable_padding=padding)
    want = jax_trace.NativeLruTrace(la, vals, cdf, seed=seed, enable_padding=padding)
    for n in (1, 80, 1000, 3):
        np.testing.assert_array_equal(got.generate(n), want.generate(n))
        assert got.i == want.i
    np.testing.assert_array_equal(got.lines, want.lines)


@pytest.mark.parametrize("fmt", ["3line", "2line"])
def test_cli_round_trip_equals_jax(tmp_path, fmt):
    """``profile`` writes the JAX CLI's files; ``generate`` (numpy stream and
    the native one) writes the JAX CLI's traces; re-profiling a trace gives
    the JAX CLI's distribution file."""
    files = {}
    for tag, cli in (("port", trace.main), ("jax", jax_trace.main)):
        dist = tmp_path / f"{tag}_dist.txt"
        extra = ["--format", "2line", "--out-prob", str(tmp_path / f"{tag}_prob.txt")] \
            if fmt == "2line" else []
        cli(["profile", "--zipf-lines", "200", "--samples", "5000", "--out", str(dist)] + extra)
        for impl in ("numpy", "auto"):
            out = tmp_path / f"{tag}_{impl}.txt"
            cli(["generate", "--dist-file", str(dist), "--length", "3000", "--seed", "3",
                 "--table-size", "500", "--impl", impl, "--out", str(out)])
            again = tmp_path / f"{tag}_{impl}_again.txt"
            cli(["profile", "--trace-file", str(out), "--out", str(again)])
            files[tag, impl] = (out.read_bytes(), again.read_bytes())
        files[tag, "dist"] = dist.read_bytes()
        if fmt == "2line":
            files[tag, "prob"] = (tmp_path / f"{tag}_prob.txt").read_bytes()
    for key in [k for k in files if k[0] == "port"]:
        assert files[key] == files[("jax",) + key[1:]], key
    ids = [int(x) for x in files["port", "numpy"][0].split()]
    assert len(ids) == 3000
    if fmt == "3line":  # only profiled lines appear
        assert set(ids) <= set(trace.read_dist_from_file(tmp_path / "port_dist.txt")[0])
