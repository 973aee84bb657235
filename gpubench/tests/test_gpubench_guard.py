"""The import guard of ``run.py``: top-level module names compared
whole."""

import pytest

import run


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("sdf_tpu", True), ("sdf_tpu.core.engine", True),
    ("sdf_torch", False), ("sdf_torch.core.engine", False),
    ("jaxtyping", False), ("sdf_tpux", False), ("numpy", False),
])
def test_forbidden_modules(name, bad):
    assert run.forbidden_modules(["os", name]) == ([name] if bad else [])


def test_run_refuses_a_tree_without_the_program(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "ROOT", tmp_path)
    (tmp_path / "BENCHMARK.json").write_text("{}")
    assert run.main(["--workload", "knurling.edit_2p26", "--seed", "1",
                     "--seconds", "1"]) == 2
