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
