"""The port's convergence harness against the JAX package's in its
TIMIT-shaped mode (tools/convergence_torch.py --timit-shape), on the CPU
at --small widths: the 3-stage curriculum, one epoch a stage (boot on the
<=17-token subset, full on the whole corpus with the same trainer, awn a
new trainer seeded seed + 1 from the full stage's weights), with JAX's
dropout and weight-noise draws swapped in. The same rows stage by stage,
under the same stage tags, at tests/test_torch_convergence.py's
tolerances (its helpers load and run both harnesses); AWN's
awn_sigma_rms and param_norm within rtol 1e-4 too.
"""

import json

import numpy as np

from seq2seq_attention_asr_tpu_torch.train import trainer
from test_torch_convergence import (ROW_EQUAL, assert_rows_match, harnesses,  # noqa: F401
                                    one_thread, run_jax, run_port)


def test_timit_shape_stages_match_the_jax_harness(harnesses, tmp_path, monkeypatch, one_thread):
    """One epoch of each stage (boot, full, awn) with JAX's draws: each new
    port trainer draws as a JAX trainer seeded with its tcfg.seed would
    (the AWN stage's seed + 1), the boot and full stages from one key."""
    from test_torch_dropout import JaxDraws

    jmod, pmod = harnesses
    argv = ["--small", "--timit-shape", "--host-features", "--train-utts", "40",
            "--valid-utts", "8", "--stage-epochs", "1,1,1", "--decode-every", "1"]
    jrec, want = run_jax(jmod, argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)

    init = trainer.Trainer.init

    def drawn_init(tr, params):
        state = init(tr, params)
        draws = JaxDraws(tr.tcfg.seed)
        draws.install(monkeypatch)
        step = tr.step_fn

        def drawn_step(state, batch):
            draws.next_step()
            return step(state, batch)

        tr.step_fn = drawn_step
        return state

    monkeypatch.setattr(trainer.Trainer, "init", drawn_init)
    _, got = run_port(pmod, argv + ["--out", str(tmp_path / "port.json")], monkeypatch,
                      init_params=jrec.inits[0])
    assert [r["stage"] for r in got] == [r["stage"] for r in want] == ["boot", "full", "awn"]
    assert [r["epoch"] for r in got] == [1, 2, 1]
    assert "valid_per" not in got[0] and "valid_per" in got[1]  # boot decodes every 20
    assert_rows_match(got, want, ROW_EQUAL + ("stage",))
    for k in ("awn_sigma_rms", "param_norm"):
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-4, err_msg=k)
    with open(tmp_path / "port.json") as f:
        meta = json.load(f)["meta"]
    assert meta["host_features"] is True and meta["corpus"]["bootstrap_utts"] > 0
