"""Stack-distance trace profiling and synthetic trace generation.

Reference: ``data_generator/trace_profile.py`` (windowed stack-distance
profiling of an index trace into PDF/CDF files) and
``data_generator/trace_generator.py`` (LRU-stack synthetic trace replay
from a CDF). These model the temporal locality of production embedding-id
streams so synthetic load has realistic cache behavior.

A copy of ``deeprecsys_tpu/data/trace.py`` (the port imports nothing of the
JAX package): the same numpy draws in the same order, so one seed gives
the same distributions and traces in both packages. ``NativeLruTrace``
binds the port's own build of the byte-equal C++ runtime.

The LRU stack model: maintain the unique lines in LRU order; for each new
reference draw a stack distance ``sd`` from the measured distribution;
``sd == 0`` introduces the next never-seen line, otherwise re-reference the
line at depth ``sd`` and move it to the top.
"""

from __future__ import annotations

import bisect

import numpy as np


def trace_profile(trace):
    """Profile a 1-D index trace into (unique_lines, stack_distances).

    For each access, the stack distance is its depth in the LRU stack
    (0 = first-ever reference). Mirrors ``trace_profile.py:39-64``.
    """
    rstack: list[int] = []  # LRU stack, most recent at the end
    stack_distances: list[int] = []
    line_accesses: list[int] = []
    for x in trace:
        x = int(x)
        try:
            depth = len(rstack) - rstack.index(x)
            rstack.remove(x)
            stack_distances.append(depth)
        except ValueError:
            stack_distances.append(0)
            line_accesses.append(x)
        rstack.append(x)
    return line_accesses, stack_distances


def compute_distributions(stack_distances):
    """Turn raw stack distances into (support, pdf, cdf) arrays."""
    vals, counts = np.unique(np.asarray(stack_distances, dtype=np.int64), return_counts=True)
    pdf = counts / counts.sum()
    cdf = np.cumsum(pdf)
    cdf[-1] = 1.0
    return vals.tolist(), pdf.tolist(), cdf.tolist()


def write_dist_file(path, line_accesses, list_sd, cumm_sd):
    """Write the distribution file format the reference consumes
    (``read_dist_from_file``, dlrm_data_caffe2.py:355-367): three lines —
    unique line accesses, stack-distance support, stack-distance CDF."""
    with open(path, "w") as f:
        f.write(", ".join(str(int(x)) for x in line_accesses) + "\n")
        f.write(", ".join(str(int(x)) for x in list_sd) + "\n")
        f.write(", ".join(repr(float(x)) for x in cumm_sd) + "\n")


def validate_cdf(cumm_sd, source: str = "<dist>"):
    """Reject a distribution file whose third/second line is not a CDF.

    The 2-line PDF companion (``sd_prob``) is byte-format-identical to the
    CDF file (``sd_cumm``); feeding it to the generator would bisect over
    a non-monotone array and silently produce heavily biased traces."""
    c = np.asarray(cumm_sd, dtype=np.float64)
    if c.size == 0 or np.any(np.diff(c) < -1e-12) or not (0.98 <= c[-1] <= 1.0 + 1e-9):
        raise ValueError(
            f"{source}: distribution is not a CDF (non-decreasing, ending "
            f"at ~1.0) — did you pass the PDF (sd_prob) file instead of "
            f"the CDF (sd_cumm)?")


def read_dist_from_file(path):
    """Read a stack-distance distribution file, auto-detecting both formats
    the reference ships:

    - 3-line (``dlrm_data_caffe2.py:355-367``): line accesses, SD support,
      SD CDF — returned as ``(line_accesses, list_sd, cumm_sd)``.
    - 2-line (``trace_generator.py:33-45``, the format of the shipped
      ``profile/sd_cumm`` / ``sd_prob``): SD support, SD values only —
      returned as ``(None, list_sd, vals)``. The reference synthesizes
      ``line_accesses`` separately from ``--table_size``
      (``trace_generator.py:70``); callers here do the same (see
      :func:`random_line_accesses`).
    """
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if len(lines) == 2:
        list_sd = [int(float(x)) for x in lines[0].strip().split(",")]
        vals = [float(x) for x in lines[1].strip().split(",")]
        return None, list_sd, vals
    line_accesses = [int(float(x)) for x in lines[0].strip().split(",")]
    list_sd = [int(float(x)) for x in lines[1].strip().split(",")]
    cumm_sd = [float(x) for x in lines[2].strip().split(",")]
    return line_accesses, list_sd, cumm_sd


def write_dist_file_2line(path, list_sd, vals):
    """Write the reference's offline 2-line distribution format
    (``trace_profile.py:67-77`` ``write_dist_to_file``): SD support on
    line 1, SD probabilities or CDF on line 2 — byte-compatible with the
    shipped ``profile/sd_cumm`` / ``sd_prob`` consumed by
    ``trace_generator.py``."""
    with open(path, "w") as f:
        f.write(", ".join(str(int(x)) for x in list_sd) + "\n")
        f.write(", ".join(repr(float(x)) for x in vals) + "\n")


def read_trace_file(path):
    """Read a raw index trace, tolerant of both the reference's shipped
    comma-separated single-line format (``syn_traces/tbl1``, written by
    ``trace_generator.py:100-108``) and whitespace/newline-separated ids
    (``trace_profile.py:32-36`` reads with ``sep=' '``)."""
    text = open(path).read().replace(",", " ")
    return np.asarray([int(float(x)) for x in text.split()], dtype=np.int64)


def random_line_accesses(table_size: int, rng=None):
    """The reference's ``line_accesses`` bootstrap for generation from a
    2-line distribution file: a random permutation of the table's row ids
    (``trace_generator.py:70`` ``random.sample(range(table_size),
    table_size)``)."""
    if rng is None:
        rng = np.random.default_rng()
    return [int(x) for x in rng.permutation(table_size)]


def generate_stack_distance(cumm_val, cumm_dist, max_i, i, rng, enable_padding=False):
    """Sample one stack distance from the CDF (dlrm_data_caffe2.py:282-299).

    While fewer than ``max_i`` unique lines have been introduced, the
    support is shrunk so distances beyond the current stack depth cannot be
    drawn; with padding enabled, new references are disabled once all lines
    have been seen.
    """
    u = rng.random()
    if i < max_i:
        j = bisect.bisect(cumm_val, i) - 1
        fi = cumm_dist[j]
        u *= fi
    elif enable_padding:
        fi = cumm_dist[0]
        u = (1.0 - fi) * u + fi
    j = bisect.bisect_left(cumm_dist, u)
    return cumm_val[min(j, len(cumm_val) - 1)]


def trace_generate_lru(line_accesses, list_sd, cumm_sd, out_trace_len,
                       enable_padding=False, rng=None, i_start: int = 0,
                       return_i: bool = False):
    """Generate ``out_trace_len`` references via the LRU stack model
    (dlrm_data_caffe2.py:251-275). ``line_accesses`` is rotated in place,
    exactly as in the reference, so successive calls continue the stream.

    ``i_start``/``return_i`` carry the introduced-lines counter across
    calls: the reference generates the whole trace in ONE call
    (trace_generator.py:137), so a caller issuing many short calls must
    thread ``i`` through to sample the same distribution — the warm-up
    phase (distances clipped to the lines seen so far) happens once per
    STREAM, not once per call; resetting it re-biases every call toward
    small distances. The native ``NativeLruTrace`` persists it the same
    way.
    """
    if rng is None:
        rng = np.random.default_rng()
    max_sd = list_sd[-1]
    l = len(line_accesses)
    i = i_start
    ztrace = []
    for _ in range(out_trace_len):
        sd = generate_stack_distance(list_sd, cumm_sd, max_sd, i, rng, enable_padding)
        if sd == 0:  # introduce the next unseen line
            line_ref = line_accesses.pop(0)
            line_accesses.append(line_ref)
            i += 1
        else:  # re-reference the line at LRU depth sd
            pos = max(0, min(l - 1, l - sd))
            line_ref = line_accesses.pop(pos)
            line_accesses.append(line_ref)
        ztrace.append(int(line_ref))
    if return_i:
        return ztrace, i
    return ztrace


def synthesize_zipf_distribution(num_lines: int, alpha: float = 1.05, num_samples: int = 10000, seed: int = 0):
    """Create a plausible stack-distance distribution without production
    traces: profile a Zipf-distributed synthetic access stream. Stands in
    for the reference's shipped ``profile/sd_cumm`` example data."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=num_samples)
    trace = np.mod(raw, num_lines)
    line_accesses, sds = trace_profile(trace)
    vals, _pdf, cdf = compute_distributions(sds)
    return line_accesses, vals, cdf


def main(argv=None):
    """Offline CLI, the ``trace_profile.py`` / ``trace_generator.py``
    analog (reference usage: profile a real id trace into a distribution
    file, then synthesize arbitrarily long traces from it):

      python -m deeprecsys_tpu_torch.data.trace profile \
          [--trace-file ids.txt | --zipf-lines 1000] --out dist.txt
      python -m deeprecsys_tpu_torch.data.trace generate \
          --dist-file dist.txt --length 65536 --out trace.txt
    """
    import argparse

    ap = argparse.ArgumentParser(description="stack-distance trace tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("profile", help="index trace -> distribution file")
    p.add_argument("--trace-file", help="text file of whitespace/comma-separated ids")
    p.add_argument("--zipf-lines", type=int, default=0,
                   help="no trace file: profile a synthetic Zipf stream over N lines")
    p.add_argument("--zipf-alpha", type=float, default=1.05)
    p.add_argument("--samples", type=int, default=100_000)
    p.add_argument("--out", required=True)
    p.add_argument("--format", choices=("3line", "2line"), default="3line",
                   help="3line: self-contained (with line accesses, "
                        "dlrm_data_caffe2.py:355-367); 2line: the reference's "
                        "offline profile/sd_cumm format (trace_profile.py:67-77)")
    p.add_argument("--out-prob", default=None,
                   help="with --format 2line: also write the PDF companion "
                        "file (the reference's profile/sd_prob)")

    g = sub.add_parser("generate", help="distribution file -> synthetic trace")
    g.add_argument("--dist-file", required=True)
    g.add_argument("--length", type=int, required=True)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)
    g.add_argument("--table-size", type=int, default=1_000_000,
                   help="for 2-line dist files (no line accesses): table row "
                        "count to draw the random line-access order from "
                        "(trace_generator.py:70,119)")
    g.add_argument("--impl", choices=("auto", "native", "numpy"),
                   default="auto",
                   help="auto: the native C++ generator when built (the "
                        "same LRU model; its own deterministic splitmix64 "
                        "stream), else the numpy loop. numpy: force the "
                        "reference-faithful rng stream")

    args = ap.parse_args(argv)
    if args.cmd == "profile":
        if args.trace_file:
            trace = read_trace_file(args.trace_file)
            line_accesses, sds = trace_profile(trace)
            vals, pdf, cdf = compute_distributions(sds)
        elif args.zipf_lines > 0:
            line_accesses, vals, cdf = synthesize_zipf_distribution(
                args.zipf_lines, args.zipf_alpha, args.samples)
            pdf = None
        else:
            ap.error("need --trace-file or --zipf-lines")
        if args.format == "2line":
            write_dist_file_2line(args.out, vals, cdf)
            if args.out_prob:
                if pdf is None:
                    pdf = np.diff(np.asarray(cdf), prepend=0.0).tolist()
                write_dist_file_2line(args.out_prob, vals, pdf)
        else:
            write_dist_file(args.out, line_accesses, vals, cdf)
        print(f"profiled {len(line_accesses)} unique lines, "
              f"{len(vals)} stack-distance bins -> {args.out}")
    else:
        rng = np.random.default_rng(args.seed)
        line_accesses, list_sd, cumm_sd = read_dist_from_file(args.dist_file)
        validate_cdf(cumm_sd, args.dist_file)
        if line_accesses is None:  # 2-line file: synthesize the access order
            line_accesses = random_line_accesses(args.table_size, rng)
        if args.impl != "numpy":
            from deeprecsys_tpu_torch.runtime.native import native_available

            if native_available():
                gen = NativeLruTrace(line_accesses, list_sd, cumm_sd,
                                     seed=args.seed)
                trace = gen.generate(args.length).tolist()
            elif args.impl == "native":
                raise SystemExit("--impl native requested but the native "
                                 "runtime is not built")
            else:
                trace = trace_generate_lru(line_accesses, list_sd, cumm_sd,
                                           args.length, rng=rng)
        else:
            trace = trace_generate_lru(line_accesses, list_sd, cumm_sd,
                                       args.length, rng=rng)
        with open(args.out, "w") as f:
            f.write("\n".join(str(x) for x in trace) + "\n")
        print(f"generated {len(trace)} references over "
              f"{len(set(trace))} unique lines -> {args.out}")


class NativeLruTrace:
    """Stateful native LRU trace stream (C++ ``drs_trace_generate_lru``),
    deterministic via its own splitmix64 state. The same LRU-stack model as
    ``trace_generate_lru``; its random stream differs from the numpy path
    (each is reproducible under its seed), and equals the JAX package's
    ``NativeLruTrace`` for the same seed."""

    def __init__(self, line_accesses, list_sd, cumm_sd, seed: int = 0,
                 enable_padding: bool = False):
        import ctypes

        from deeprecsys_tpu_torch.runtime.native import get_lib

        self._lib = get_lib()
        self._ct = ctypes
        self.lines = np.ascontiguousarray(line_accesses, dtype=np.int64)
        self.sd_vals = np.ascontiguousarray(list_sd, dtype=np.int64)
        self.sd_cdf = np.ascontiguousarray(cumm_sd, dtype=np.float64)
        self.head = np.zeros(1, dtype=np.int64)
        mix = (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % (1 << 64)
        self.state = np.array([mix], dtype=np.uint64)
        self.i = 0
        self.enable_padding = enable_padding

    def generate(self, out_len: int) -> np.ndarray:
        ct = self._ct
        out = np.empty(out_len, dtype=np.int64)
        self.i = self._lib.drs_trace_generate_lru(
            self.lines.ctypes.data_as(ct.c_void_p), len(self.lines),
            self.head.ctypes.data_as(ct.c_void_p),
            self.sd_vals.ctypes.data_as(ct.c_void_p),
            self.sd_cdf.ctypes.data_as(ct.c_void_p), len(self.sd_vals),
            out_len, out.ctypes.data_as(ct.c_void_p),
            self.state.ctypes.data_as(ct.c_void_p),
            int(self.enable_padding), self.i,
        )
        return out


if __name__ == "__main__":
    main()
