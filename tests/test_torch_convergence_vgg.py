"""The port's convergence harness against the JAX package's for the VGG
recipe through the out-of-core chunked epoch (--model vgg --chunks 2),
on the CPU at --small widths: case (b) of tests/test_torch_convergence.py,
whose helper runs both harnesses. VGG's free-running rows are held for
the first epoch only (that file's docstring says why); both epochs'
steps are held along JAX's trajectory.
"""

from test_torch_convergence import check_default_fit, one_thread  # noqa: F401


def test_vgg_chunked_rows_match_the_jax_harness(tmp_path, monkeypatch, one_thread):
    check_default_fit(["--model", "vgg", "--chunks", "2"], tmp_path, monkeypatch, held_epochs=1)


def test_the_default_mode_takes_a_compute_dtype(tmp_path, one_thread):
    """--compute-dtype outside --timit-shape: the recipe's model in bf16
    (meta records it), its epoch finite; without the flag, float32."""
    import json

    from test_torch_convergence import ROOT, load

    mod = load("convergence_torch_harness", ROOT / "tools" / "convergence_torch.py")
    argv = ["--cpu", "--small", "--model", "vgg", "--train-utts", "8", "--valid-utts", "2",
            "--epochs", "1", "--decode-every", "1"]
    for dtype in ("bfloat16", None):
        out = tmp_path / f"{dtype}.json"
        rows = mod.main(argv + ["--out", str(out)] + (["--compute-dtype", dtype] if dtype else []))
        model = json.loads(out.read_text())["meta"]["model"]
        assert model.get("compute_dtype") == dtype
        assert len(rows) == 1 and all(abs(rows[0][k]) < 1e6 for k in ("train_nll", "valid_per"))
    args = mod.parse_args(argv + ["--compute-dtype", "bfloat16", "--out", "x"])
    model, _ = mod.default_model(args, 41)
    assert model.cfg.compute_dtype == "bfloat16"
