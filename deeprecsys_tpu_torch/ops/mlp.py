"""MLP towers.

Counterpart of ``deeprecsys_tpu/ops/mlp.py``. Weights keep the JAX layout,
``w`` is ``(in, out)``, so the forward is ``x @ w + b``. Numerics follow
the JAX op exactly: the product accumulates in f32, bias and activation are
applied in f32, and the result is cast to the input dtype at each layer
boundary. A plain bf16 ``x @ w + b`` would round before the bias.

The products are plain matmuls; the JAX package leaves them to XLA outside
any kernel, and the port leaves them to ``torch.matmul``.
"""

from __future__ import annotations

import math

import torch


def mlp_init(dims, dtype: torch.dtype, generator: torch.Generator,
             device: torch.device | str) -> list[dict]:
    """An MLP for layer sizes ``dims = [in, h1, ..., out]``:
    w ~ N(0, sqrt(2/(in+out))), b ~ N(0, sqrt(1/out))
    (reference ``dlrm_s_caffe2.py:243-252``)."""
    params = []
    for n, m in zip(dims[:-1], dims[1:]):
        w = torch.randn((n, m), generator=generator, device=device) * math.sqrt(2.0 / (m + n))
        b = torch.randn((m,), generator=generator, device=device) * math.sqrt(1.0 / m)
        params.append({"w": w.to(dtype), "b": b.to(dtype)})
    return params


def mlp_apply(params, x: torch.Tensor, sigmoid_layer: int = -1,
              final_relu: bool = True) -> torch.Tensor:
    """Run the MLP.

    ``sigmoid_layer`` is 1-based as in the reference (``create_mlp``'s
    ``i == sigmoid_layer``); -1 means all-ReLU. ``final_relu=False`` leaves
    the last layer's pre-activation exposed unless the sigmoid hits it.
    """
    out_dtype = x.dtype
    n = len(params)
    for i, layer in enumerate(params, start=1):
        # bf16 x bf16 products are exact in f32, so the f32 upcast gives
        # the f32-accumulated product of the JAX op.
        y = x.float() @ layer["w"].float() + layer["b"].float()
        if i == sigmoid_layer:
            y = torch.sigmoid(y)
        elif i < n or final_relu:
            y = torch.relu(y)
        x = y.to(out_dtype)
    return x
