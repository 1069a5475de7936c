"""The port's public names are the JAX package's, and each resolves."""

import ldweaver_tpu
import ldweaver_tpu_torch


def test_all_equals_the_jax_packages():
    assert set(ldweaver_tpu_torch.__all__) == set(ldweaver_tpu.__all__)
    assert len(ldweaver_tpu_torch.__all__) == len(set(ldweaver_tpu_torch.__all__))


def test_every_name_resolves_to_the_port():
    for name in ldweaver_tpu_torch.__all__:
        obj = getattr(ldweaver_tpu_torch, name)
        assert callable(obj), name
        assert obj.__module__.startswith("ldweaver_tpu_torch."), name
        assert getattr(ldweaver_tpu, name).__name__ == obj.__name__, name
