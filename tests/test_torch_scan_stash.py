"""The global scratch of the decoder-scan backwards K5, K11, K13 and K15
(ops/cuda/attention_scan.py::stash_floats, the host's copy of the
kernels' carve_stash), pinned at the recipes' training shapes. The walk
sums the location term's weight gradients itself, so that term's scratch
is a per-row dz of L*S floats and a block's partial sums (with dw_e's,
which every walk sums so): it does not grow with the number of steps T.
Plain arithmetic, so this runs on the CPU; the last test holds
stash_floats to carve_stash's source."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda.attention_scan import ScanPlan, stash_floats

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch"
          / "csrc" / "attention_scan_loc_lstm.cu")
# (lstm, T, L, S, St, FM, F): flagship_loc (the flagship recipe with 16
# feature maps of filter 10, K13) at B=16 and 128, and the conv+BiLSTM
# recipe (K11: 144 frames give L'=16) at B=16, each on 4 clusters of 16
# blocks a batch of 16 (64 rows of partials).
FLAGSHIP_LOC = (False, 56, 144, 512, 256, 16, 10)
CONV_BILSTM = (True, 56, 16, 150, 400, 16, 5)
# The flagship recipe itself (K5: the GRU without the location term).
FLAGSHIP = (False, 56, 144, 512, 256, 0, 0)
RECIPE_PLAN = ScanPlan(16, 4)


def _floats(shape, b, t_len=None):
    lstm, t, l, s_dim, st, fm, f = shape
    return stash_floats(lstm, b, t_len or t, l, s_dim, st, fm, f, RECIPE_PLAN.partials(b))


@pytest.mark.parametrize("shape,b,want", [
    (FLAGSHIP_LOC, 16, 4_729_856),    # 18.9 MB: 64 rows of partials, no per-step dw_e rows
                                      # (was 4,754,176 with them and B rows of partials)
    (FLAGSHIP_LOC, 128, 37_838_848),  # 151.4 MB: 512 rows of partials (was 38,033,408)
    (CONV_BILSTM, 16, 3_567_744),     # 14.3 MB: no per-step dw_e rows, 64 rows of partials
    (FLAGSHIP, 16, 3_014_656),        # 12.1 MB: K5 on 4 clusters of 16 (was 3,440,640 with
                                      # per-step dw_e rows)
    (FLAGSHIP, 128, 24_117_248),      # 96.5 MB: 32 clusters of 16
])
def test_stash_at_the_recipes_shapes(shape, b, want):
    assert _floats(shape, b) == want
    assert _floats(shape, b) < 50_000_000


@pytest.mark.parametrize("shape", [FLAGSHIP_LOC, CONV_BILSTM])
@pytest.mark.parametrize("b", [1, 16, 128])
def test_location_share_does_not_grow_with_the_steps(shape, b):
    """Twice the steps add only the per-step stash of the content-only
    scan; the location term's share is B * L*S of dz and the partials of
    dU, dwconv and dbconv, a row per block of the walk, for K13 as for
    K11."""
    lstm, t, l, s_dim, st, fm, f = shape
    partials = RECIPE_PLAN.partials(b)
    # The stash without the location term: K15's for K11, K5's for K13.
    content = lambda t_len: stash_floats(lstm, b, t_len, l, s_dim, st, partials=partials)
    for t_len in (1, t, 2 * t):
        assert _floats(shape, b, t_len) - content(t_len) == (
            b * l * s_dim + partials * (fm * s_dim + (f + 1) * fm))


def _carve_stash_floats(lstm, loc, B, T, L, S, St, FM, F, partials):
    """The floats carve_stash<lstm, loc> takes, from its source: its
    statements read as Python (declarations, `if` blocks, the takes)."""
    body = re.search(r"Stash carve_stash\(float\* p, const Dims& d, int partials\) \{\n(.*?)\n\}\n",
                     SOURCE.read_text(), re.S).group(1)
    py, depth = ["total = 0"], 0
    for line in body.splitlines():
        line = line.strip().replace("(size_t)", "").replace("d.", "")
        line = line.replace("kLstm", "lstm").replace("kLoc", "loc")
        line = re.sub(r"//.*", "", line).strip()
        if line in ("Carver c{p, 0};", "Stash s{};", "return s;", ""):
            continue
        pad = "    " * depth
        take = r"s\.\w+ = c\.take\((.*)\);"
        if line == "} else {":
            py.append("    " * (depth - 1) + "else:")
        elif line == "}":
            depth -= 1
        elif m := re.fullmatch(r"if \((\w+)\) \{", line):
            py.append(f"{pad}if {m.group(1)}:")
            depth += 1
        elif m := re.fullmatch(r"if \((!?)(\w+)\) " + take, line):
            py.append(f"{pad}if {'not ' * bool(m.group(1))}{m.group(2)}: total += {m.group(3)}")
        elif m := re.fullmatch(take, line):
            py.append(f"{pad}total += {m.group(1)}")
        elif m := re.fullmatch(r"const size_t (.*);", line):
            py += [f"{pad}{decl.strip()}" for decl in m.group(1).split(",")]
        else:
            raise AssertionError(f"carve_stash: no reading of {line!r}")
    scope = dict(lstm=lstm, loc=loc, B=B, T=T, L=L, S=S, St=St, FM=FM, F=F, partials=partials)
    exec("\n".join(py), scope)
    return scope["total"]


@pytest.mark.parametrize("lstm,loc", [(True, True), (False, True), (True, False), (False, False)])
@pytest.mark.parametrize("b,t_len,l,s_dim,st,fm,f,partials", [
    (16, 56, 16, 150, 400, 16, 5, 64), (3, 5, 13, 17, 9, 3, 4, 16),
    (128, 56, 144, 512, 256, 16, 10, 128),
    (1, 1, 1, 1, 1, 1, 1, 8)])
def test_stash_floats_is_what_carve_stash_takes(lstm, loc, b, t_len, l, s_dim, st, fm, f, partials):
    """Every instance of the walk, with `partials` rows of partial sums:
    K11 (LSTM, location), K13 (GRU, location), K15 (LSTM) and K5 (GRU)."""
    fm, f = (fm, f) if loc else (0, 0)
    want = _carve_stash_floats(lstm, loc, b, t_len, l, s_dim, st, fm, f, partials)
    assert stash_floats(lstm, b, t_len, l, s_dim, st, fm, f, partials) == want
