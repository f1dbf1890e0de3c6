"""GRU and LSTM cell math (seq2seq_attention_asr_tpu/ops/cells.py).

The reference GRU (GRU.lua:22-30) is bias-free, its gates act on
``concat([h, x])`` (h first), and the reset gate multiplies h BEFORE
the candidate matmul: ``tanh((r*h) @ W_h + x @ W_x)``. That is not
``torch.nn.GRU``/cuDNN, which apply r after the matmul and carry
biases. Kernels are input-major ``(H + I, out)``; the z/r kernels are
fused along the output axis into ``w_zr`` (H + I, 2H).

The LSTM (LSTM.lua:25-58) is the usual one, gates (in, forget, cell,
out) with biases; its peephole option is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def torch_linear_init(generator: torch.Generator, fan_in: int, shape) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the CPU so that a
    seed gives the same weights whatever device they are moved to."""
    bound = 1.0 / float(fan_in) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def gru_init(generator: torch.Generator, dim_in: int, dim_out: int) -> Params:
    fan_in = dim_in + dim_out
    w_z = torch_linear_init(generator, fan_in, (fan_in, dim_out))
    w_r = torch_linear_init(generator, fan_in, (fan_in, dim_out))
    w_h = torch_linear_init(generator, fan_in, (fan_in, dim_out))
    return {"w_zr": torch.cat([w_z, w_r], dim=1), "w_h": w_h}


def gru_step(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. x: (..., I), h: (..., H) -> new h (..., H)."""
    zr = torch.sigmoid(torch.cat([h, x], dim=-1) @ params["w_zr"])
    z, r = zr.chunk(2, dim=-1)
    h_cand = torch.tanh(torch.cat([r * h, x], dim=-1) @ params["w_h"])
    return (1.0 - z) * h + z * h_cand


def gru_input_proj(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Input-side projection ``x @ [Wz_x | Wr_x | Wh_x]`` -> (..., 3H),
    hoisted out of the time loop as one large matmul."""
    h_dim = params["w_zr"].shape[1] // 2
    wx = torch.cat([params["w_zr"][h_dim:], params["w_h"][h_dim:]], dim=1)
    return x @ wx


def gru_step_preproj(params: Params, xproj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GRU step given the precomputed input projection (..., 3H)."""
    h_dim = params["w_zr"].shape[1] // 2
    xz, xr, xh = xproj.split(h_dim, dim=-1)
    zr = torch.sigmoid(h @ params["w_zr"][:h_dim] + torch.cat([xz, xr], dim=-1))
    z, r = zr.chunk(2, dim=-1)
    h_cand = torch.tanh((r * h) @ params["w_h"][:h_dim] + xh)
    return (1.0 - z) * h + z * h_cand


def lstm_init(generator: torch.Generator, dim_in: int, dim_out: int,
              peepholes: bool = False) -> Params:
    """LSTM weights, gate order (in, forget, cell, out): w_x (I, 4H),
    w_h (H, 4H) and one bias b (4H), the sum of the reference's i2h and
    h2h biases (LSTM.lua:26-27). Peepholes are not ported."""
    if peepholes:
        raise NotImplementedError("LSTM peepholes are not ported")
    wx = [torch_linear_init(generator, dim_in, (dim_in, dim_out)) for _ in range(4)]
    wh = [torch_linear_init(generator, dim_out, (dim_out, dim_out)) for _ in range(4)]
    bx = [torch_linear_init(generator, dim_in, (dim_out,)) for _ in range(4)]
    bh = [torch_linear_init(generator, dim_out, (dim_out,)) for _ in range(4)]
    return {"w_x": torch.cat(wx, dim=1), "w_h": torch.cat(wh, dim=1),
            "b": torch.cat([a + b for a, b in zip(bx, bh)])}


def _lstm_gates(params: Params, gates: torch.Tensor, c: torch.Tensor):
    if "w_peep" in params:
        raise NotImplementedError("LSTM peepholes are not ported")
    g_in, g_forget, g_cell, g_out = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(g_forget) * c + torch.sigmoid(g_in) * torch.tanh(g_cell)
    return torch.sigmoid(g_out) * torch.tanh(new_c), new_c


def lstm_step(params: Params, x: torch.Tensor, state):
    """One LSTM step. state = (h, c); returns (new_h, new_c)."""
    h, c = state
    return _lstm_gates(params, x @ params["w_x"] + h @ params["w_h"] + params["b"], c)


def lstm_input_proj(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Input projection ``x @ w_x + b`` (..., 4H), hoisted out of the time loop."""
    return x @ params["w_x"] + params["b"]


def lstm_step_preproj(params: Params, xproj: torch.Tensor, state):
    """LSTM step given the precomputed input projection (..., 4H)."""
    h, c = state
    return _lstm_gates(params, xproj + h @ params["w_h"], c)
