"""The port's thread engines against the JAX package's, on the host CPU:
closed-loop executions a second of a pool of 1, 2 and 4 engines of each
package, with the same model, rows and request count
(``deeprecsys_tpu_torch.engine_bench.engine_arm`` drives both pools).

    python -m tests.engine_scaling [--model rm1] [--table_scale 2000]
        [--rows 32] [--executions 1000] [--engines 1 2 4]

Both packages put several engine threads in one process; the JAX engine
makes one call into a compiled program an execution, the port's eager
forward one call into PyTorch a device op. If the JAX pool keeps its rate
as engines are added and the port's does not, the loss is the port's
dispatch, not the thread design. These are host-CPU numbers, not a
device's. Not a test: run it by hand.
"""

from __future__ import annotations

import argparse

import jax

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.serving.engine import build_engine_pool as jax_build_engine_pool
from deeprecsys_tpu.serving.packets import ServiceRequest as JaxServiceRequest
from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.engine_bench import describe, engine_arm


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="rm1")
    p.add_argument("--table_scale", type=int, default=2000)
    p.add_argument("--rows", type=int, default=32)
    p.add_argument("--executions", type=int, default=1000)
    p.add_argument("--engines", type=int, nargs="+", default=[1, 2, 4])
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    port_cfg = zoo.get_config(args.model, table_scale=args.table_scale)
    jax_cfg = jax_zoo.get_config(args.model, table_scale=args.table_scale)
    for k in args.engines:
        for name, kw, cfg in (
                ("port", {}, port_cfg),
                ("jax", dict(pool_fn=jax_build_engine_pool, config_cls=JaxServingConfig,
                             request_cls=JaxServiceRequest), jax_cfg)):
            r = engine_arm(cfg, "cpu", k, args.executions, args.rows, **kw)
            print(f"[engine_scaling] {name:4s} {args.model} table_scale={args.table_scale} "
                  f"f32 rows={args.rows} engines={k}: {describe(r)} [host CPU]", flush=True)


if __name__ == "__main__":
    main()
