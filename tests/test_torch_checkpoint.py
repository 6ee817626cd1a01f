"""The port's checkpoint layer against the JAX package: reference-mangled
paths, JAX-package checkpoints loaded with identical arrays, and the trained
MNIST reference state_dict mapped as tools/convert_reference_checkpoint.py
maps it."""

import jax
import numpy as np
import pytest
import torch

from tools.convert_reference_checkpoint import convert_state_dict
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import gauss as jgauss
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.models import gauss as tgauss

TRAINED = dict(vae_type="reg_EDDI1", data_type="mnist", missing_rate=30)


@pytest.mark.parametrize("kw", [
    dict(vae_type="reg_vae1"),
    dict(vae_type="vanilla_vae2_with_drop", missing_rate=30),
    dict(vae_type="reg_EDDI_mnist1", data_type="mnist", alpha=0.5,
         reg_type="ml_reg", p_missingness=10),
    TRAINED,
])
def test_checkpoint_path_matches_jax(kw):
    assert (tckpt.checkpoint_path(tcfg.RunConfig(**kw), root="r")
            == jckpt.checkpoint_path(jcfg.RunConfig(**kw), root="r"))
    assert (tckpt.family_dir(kw["vae_type"])
            == jckpt.family_dir(kw["vae_type"]))


@pytest.mark.parametrize("vae_type,data_type", [("reg_EDDI1", "mnist"),
                                                ("vanilla_vae1", "wine")])
def test_jax_checkpoint_loads_with_identical_arrays(tmp_path, vae_type,
                                                    data_type):
    kw = dict(vae_type=vae_type, data_type=data_type)
    jparams = jgauss.init(jax.random.PRNGKey(1), jcfg.RunConfig(**kw), 20)
    path = str(tmp_path / "ck.pt")
    jckpt.save(jparams, path)
    template = tgauss.init(torch.Generator().manual_seed(0),
                           tcfg.RunConfig(**kw), 20, device="cpu")
    got = tckpt.flatten(tckpt.load(template, path))
    want = jckpt._flatten(jparams)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # a template of other widths is refused
    small = tgauss.init(torch.Generator().manual_seed(0),
                        tcfg.RunConfig(**kw), 19, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(small, path)


def test_params_from_jax_round_trips_the_flat_layout():
    jparams = jgauss.init(jax.random.PRNGKey(2),
                          jcfg.RunConfig(vae_type="reg_EDDI1"), 11)
    flat = jckpt._flatten(jparams)
    port = tckpt.params_from_jax(flat, "cpu")
    assert port["encoder"]["pnp1"]["layer0"]["w"].shape == (12, 10)
    back = tckpt.flatten(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k])


def _trained_sd():
    path = tckpt.checkpoint_path(tcfg.RunConfig(**TRAINED))
    return torch.load(path, map_location="cpu", weights_only=True)


def test_trained_reference_mapping_matches_the_jax_tool():
    sd = _trained_sd()
    got = tckpt.flatten(tckpt.convert_state_dict(sd, tcfg.RunConfig(**TRAINED),
                                                 784))
    want = jckpt._flatten(convert_state_dict(sd, jcfg.RunConfig(**TRAINED),
                                             784))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loaded = tckpt.flatten(tckpt.load_reference(
        tckpt.checkpoint_path(tcfg.RunConfig(**TRAINED)),
        tcfg.RunConfig(**TRAINED), 784, device="cpu"))
    for k in want:
        np.testing.assert_array_equal(loaded[k].numpy(), want[k], err_msg=k)


def test_reference_mapping_refuses_gaps_and_wrong_widths():
    cfg = tcfg.RunConfig(**TRAINED)
    sd = dict(_trained_sd())
    sd["stray.weight"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="not consumed"):
        tckpt.convert_state_dict(sd, cfg, 784)
    with pytest.raises(ValueError, match="shape mismatch|do not match"):
        tckpt.convert_state_dict(_trained_sd(), cfg, 783)
