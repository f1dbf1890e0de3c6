"""Convolution and pooling on padded batches
(seq2seq_attention_asr_tpu/ops/conv.py).

VALID padding, as the reference's TemporalConvolution,
TemporalMaxPooling, SpatialConvolutionMM and SpatialMaxPooling;
``conv_out_length`` carries the true lengths of a padded batch through
them. The kernel layouts are the JAX package's: (k, in, out) for the
temporal conv, HWIO for the spatial one on NHWC inputs (H is time, W
frequency), so parameter trees carry across as they are. The temporal
convolution is k shifted matrix products, which run in full float32 on
the card. The spatial one is ``F.conv2d`` (NCHW, OIHW: the layouts are
permuted where it is called). cuDNN would run a float32 one in TF32
under PyTorch's default ``torch.backends.cudnn.allow_tf32`` (True), so
``spatial_conv_nchw`` turns the flag off around a float32 convolution
and around its gradient's, and gives the caller's value back after
each (``float32_convs``, ``_Float32Conv``): float32 convolutions are
full float32 whatever the flag says, as the JAX package's are. A bf16
one (a bf16 model's) leaves the flag alone: cuDNN sums it in float32
and rounds the output to bf16, and the bias is added after, in bf16, as
the JAX package's ``conv_general_dilated`` then ``+ b`` round.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .cells import torch_linear_init

Params = Dict[str, torch.Tensor]


def temporal_conv_init(generator: torch.Generator, dim_in: int, dim_out: int, k: int) -> Params:
    """TemporalConvolution(dim_in, dim_out, k): kernel (k, in, out), bias (out,)."""
    fan_in = dim_in * k
    return {"w": torch_linear_init(generator, fan_in, (k, dim_in, dim_out)),
            "b": torch_linear_init(generator, fan_in, (dim_out,))}


def temporal_conv(params: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID 1-D cross-correlation over time: (B, L, C_in) -> (B, L', C_out),
    L' = (L - k) // stride + 1, as sum_j x[:, j + stride * t] @ w[j]."""
    w = params["w"]
    k = w.shape[0]
    out_len = max((x.shape[1] - k) // stride + 1, 0)
    span = (out_len - 1) * stride + 1
    y = x.new_zeros((x.shape[0], out_len, w.shape[2]))
    if out_len:
        for j in range(k):
            y = y + x[:, j : j + span : stride] @ w[j]
    if "b" in params:
        y = y + params["b"]
    return y


def temporal_max_pool(x: torch.Tensor, k: int, stride: Optional[int] = None) -> torch.Tensor:
    """TemporalMaxPooling(k, stride), VALID: (B, L, C) -> (B, L', C)."""
    stride = stride or k
    if x.shape[1] < k:
        return x[:, :0]
    return x.unfold(1, k, stride).amax(dim=-1)


def spatial_conv_init(generator: torch.Generator, c_in: int, c_out: int, kh: int,
                      kw: int) -> Params:
    """SpatialConvolutionMM(c_in, c_out, kw, kh): kernel (kh, kw, in, out)
    (HWIO), bias (out,)."""
    fan_in = c_in * kh * kw
    return {"w": torch_linear_init(generator, fan_in, (kh, kw, c_in, c_out)),
            "b": torch_linear_init(generator, fan_in, (c_out,))}


@contextlib.contextmanager
def float32_convs(dtype: torch.dtype):
    """For float32: cuDNN's convolutions in full float32, whatever
    torch.backends.cudnn.allow_tf32 says (PyTorch's default, True, lets
    cuDNN take TF32); the flag is restored on exit, also when the body
    raises. Nothing for other types."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


class _Float32Conv(torch.autograd.Function):
    """F.conv2d(x, w, b), stride 1, VALID, on float32, its forward and its
    backward each under float32_convs: autograd runs the backward after
    the forward's context has closed."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with float32_convs(x.dtype):
            return F.conv2d(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with float32_convs(dy.dtype):
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                list(ctx.needs_input_grad))
        return dx, dw, db


def spatial_conv_nchw(params: Params, x: torch.Tensor) -> torch.Tensor:
    """spatial_conv on NCHW: (B, C_in, H, W) -> (B, C_out, H', W'), H' = H -
    kh + 1 and W' = W - kw + 1 (clamped at 0). float32 without TF32; bf16
    with the bias added after the convolution's rounding."""
    w = params["w"]
    kh, kw, _, c_out = w.shape
    b, _, hh, ww = x.shape
    if hh < kh or ww < kw:
        return x.new_zeros((b, c_out, max(hh - kh + 1, 0), max(ww - kw + 1, 0)))
    if x.dtype == torch.bfloat16:
        return F.conv2d(x, w.permute(3, 2, 0, 1)) + params["b"][:, None, None]
    return _Float32Conv.apply(x, w.permute(3, 2, 0, 1), params["b"])


def spatial_max_pool_nchw(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int) -> torch.Tensor:
    """spatial_max_pool on NCHW: the max over each kh x kw window at
    strides (sh, sw), VALID."""
    b, c, hh, ww = x.shape
    if hh < kh or ww < kw:
        return x.new_zeros((b, c, max((hh - kh) // sh + 1, 0), max((ww - kw) // sw + 1, 0)))
    return F.max_pool2d(x, (kh, kw), (sh, sw))


def spatial_conv(params: Params, x: torch.Tensor) -> torch.Tensor:
    """VALID 2-D cross-correlation: (B, H, W, C_in) -> (B, H', W', C_out)."""
    return spatial_conv_nchw(params, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def spatial_max_pool(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int) -> torch.Tensor:
    """SpatialMaxPooling over (H, W) of NHWC, VALID. A tie's gradient goes
    to one of its inputs, as the JAX package's reduce_window does (which
    one may differ)."""
    return spatial_max_pool_nchw(x.permute(0, 3, 1, 2), kh, kw, sh, sw).permute(0, 2, 3, 1)


def conv_out_length(lengths: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """True lengths after a VALID convolution or pool of size k and stride s."""
    return torch.clamp((lengths - k) // stride + 1, min=0)
