"""The global scratch of the decoder-scan backwards K11 and K13
(ops/cuda/attention_scan.py::stash_floats, the host's copy of the
kernels' carve_stash), pinned at the recipes' training shapes. The walk
sums the location term's weight gradients itself, so that term's scratch
is a per-row dz of L*S floats and the row's partial sums: it does not
grow with the number of steps T. Plain arithmetic, so this runs on the
CPU."""

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda.attention_scan import stash_floats

# (lstm, B, T, L, S, St, FM, F): flagship_loc (the flagship recipe with 16
# feature maps of filter 10, K13) at B=16 and 128, and the conv+BiLSTM
# recipe (K11: 144 frames give L'=16) at B=16.
FLAGSHIP_LOC = (False, 56, 144, 512, 256, 16, 10)
CONV_BILSTM = (True, 56, 16, 150, 400, 16, 5)


def _floats(shape, b, t_len=None):
    lstm, t, l, s_dim, st, fm, f = shape
    return stash_floats(lstm, b, t_len or t, l, s_dim, st, fm, f)


@pytest.mark.parametrize("shape,b,want", [
    (FLAGSHIP_LOC, 16, 4_754_176),    # 19.0 MB
    (FLAGSHIP_LOC, 128, 38_033_408),  # 152.1 MB
    (CONV_BILSTM, 16, 3_572_736),     # 14.3 MB
])
def test_stash_at_the_recipes_shapes(shape, b, want):
    assert _floats(shape, b) == want
    assert _floats(shape, b) < 50_000_000


@pytest.mark.parametrize("shape", [FLAGSHIP_LOC, CONV_BILSTM])
@pytest.mark.parametrize("b", [1, 16, 128])
def test_location_share_does_not_grow_with_the_steps(shape, b):
    """Twice the steps add only the per-step stash of the content-only
    scan; the location term's share is B * (L*S + FM*S + (F + 1) * FM)."""
    lstm, t, l, s_dim, st, fm, f = shape
    content = lambda t_len: stash_floats(lstm, b, t_len, l, s_dim, st)
    for t_len in (1, t, 2 * t):
        assert _floats(shape, b, t_len) - content(t_len) == b * (l * s_dim + fm * s_dim
                                                                 + (f + 1) * fm)
