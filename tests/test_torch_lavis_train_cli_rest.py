"""The port's config CLI on albef_classification, blip_classification (a
multimodal_classification YAML) and clip (a retrieval YAML) against the
JAX package's CLI, each in fp32 and under run.amp=True: per-epoch losses
within 1e-4 of the JAX CLI's fp32 run (2e-2 under amp, bf16 compute on
fp32 masters) and, in fp32, the first step's gradient within 1e-5 of the
largest. The JAX CLI runs once per arch, in fp32, the three side by
side in threads (the harness of tests/test_torch_lavis_train_cli.py;
split from it to keep each file short)."""

import pytest

from test_torch_lavis_train_cli import check_arch_matches_jax_cli, jax_cli_runs

ARCHS = ("albef_classification", "blip_classification", "clip")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """arch → the JAX CLI's fp32 run."""
    with pytest.MonkeyPatch.context() as mp:
        return jax_cli_runs(ARCHS, tmp_path_factory.mktemp("jax_cli"), mp)


@pytest.mark.parametrize("arch,amp", [("albef_classification", False), ("blip_classification", False),
                                      ("clip", False), ("clip", True), ("albef_classification", True),
                                      ("blip_classification", True)])
def test_lavis_arch_matches_jax_cli(arch, amp, tmp_path, monkeypatch, jax_runs):
    check_arch_matches_jax_cli(arch, tmp_path, monkeypatch, jax_runs[arch], amp)
