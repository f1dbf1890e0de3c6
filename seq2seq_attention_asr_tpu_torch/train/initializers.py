"""Weight initialization: Gaussian reset and QR orthogonalization
(seq2seq_attention_asr_tpu/train/initializers.py).

The recipes call ``autoencoder:reset(init_std)`` and then
``TrainUtils.orthogonalizeGraph`` (exp0_scriptchecker.lua:48-52). The
orthogonalizer (TrainUtils.lua:5-26) QR-decomposes each module's weight
matrix, with the bias appended as a column, in Torch's (out, in) layout,
transposing first when rows < cols. Weights here are (..., fan_in, out),
so the (out, fan_in[+1]) matrix is orthogonalized and scattered back;
fused GRU and LSTM gate kernels are orthogonalized per gate. The QR runs in numpy
on the leaves' own dtype, as the JAX package's does, so the same weights
give the same result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tree import tree_map


def gaussian_reset(generator: torch.Generator, params, std: float):
    """theta ~ N(0, std^2) for every float leaf (torch :reset(std)),
    drawn on the CPU from `generator`, then moved to the leaf's device."""

    def leaf(t):
        if not t.is_floating_point():
            return t
        return (torch.randn(t.shape, generator=generator, dtype=t.dtype) * std).to(t.device)

    return tree_map(leaf, params)


def _orthogonalize_matrix(w: np.ndarray, b: Optional[np.ndarray] = None):
    """w: (fan_in, out), b: (out,) or None. Returns orthogonalized (w, b):
    qr(A) of A = [w^T | b] (out, fan_in(+1)) when out >= cols, else
    qr(A^T)^T, split back."""
    a = w.T
    if b is not None:
        a = np.concatenate([a, b[:, None]], axis=1)
    if a.shape[0] < a.shape[1]:
        q, _ = np.linalg.qr(a.T)
        q = q.T
    else:
        q, _ = np.linalg.qr(a)
    if b is not None:
        return np.ascontiguousarray(q[:, :-1].T), np.ascontiguousarray(q[:, -1])
    return np.ascontiguousarray(q.T), None


def _orth_blocks(w: np.ndarray, n_blocks: int, b: Optional[np.ndarray] = None):
    """Orthogonalize each of n_blocks equal slices along the output axis."""
    out = w.shape[-1]
    if out % n_blocks:
        raise ValueError(f"{out} outputs do not split into {n_blocks} blocks")
    size = out // n_blocks
    w = w.copy()
    b = b.copy() if b is not None else None
    for i in range(n_blocks):
        sl = slice(i * size, (i + 1) * size)
        wi, bi = _orthogonalize_matrix(w[..., sl].reshape(-1, size), b[sl] if b is not None else None)
        w[..., sl] = wi.reshape(w[..., sl].shape)
        if bi is not None:
            b[sl] = bi
    return w, b


def orthogonalize_params(params):
    """Walk the tree and QR-orthogonalize every weight matrix:
      - {"w", "b"} linear pairs: bias-augmented QR (kernels flattened to
        (k*in, out) first);
      - GRU cells: w_zr as two (fan_in, H) matrices, w_h as one, no bias
        (LinearZeroBias, GRU.lua:23-26);
      - LSTM cells: w_x per gate with its (summed) gate bias, w_h per gate
        without bias;
      - bare 2-D leaves v and u: plain QR; 1-D leaves (w_e) untouched.
    LSTM peepholes are not ported and are refused."""

    def as_np(t):
        return t.detach().cpu().numpy()

    def back(a, like):
        return torch.from_numpy(a).to(like.device)

    def walk(node):
        if isinstance(node, dict):
            if "w_x" in node:
                if "w_peep" in node:
                    raise NotImplementedError("LSTM peepholes are not ported")
                w_x, b = _orth_blocks(as_np(node["w_x"]), 4, as_np(node["b"]))
                w_h, _ = _orth_blocks(as_np(node["w_h"]), 4)
                return dict(node, w_x=back(w_x, node["w_x"]), b=back(b, node["b"]),
                            w_h=back(w_h, node["w_h"]))
            if "w_zr" in node:
                w_zr, _ = _orth_blocks(as_np(node["w_zr"]), 2)
                w_h, _ = _orthogonalize_matrix(as_np(node["w_h"]))
                return dict(node, w_zr=back(w_zr, node["w_zr"]), w_h=back(w_h, node["w_h"]))
            if "w" in node and node["w"].ndim >= 2:
                w = as_np(node["w"])
                b = as_np(node["b"]) if "b" in node else None
                wo, bo = _orthogonalize_matrix(w.reshape(-1, w.shape[-1]), b)
                new = dict(node, w=back(wo.reshape(w.shape), node["w"]))
                if bo is not None:
                    new["b"] = back(bo, node["b"])
                return new
            out = {}
            for k, v in node.items():
                if isinstance(v, torch.Tensor) and v.ndim >= 2 and k in ("v", "u"):
                    wo, _ = _orthogonalize_matrix(as_np(v).reshape(-1, v.shape[-1]))
                    out[k] = back(wo.reshape(v.shape), v)
                elif isinstance(v, (dict, list)):
                    out[k] = walk(v)
                else:
                    out[k] = v
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
