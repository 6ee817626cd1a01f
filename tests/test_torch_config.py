"""Port config and registry against the JAX package: the vae_type master
switch parses identically, RunConfig keeps the JAX defaults, and get_model
routes the gauss families and refuses the rest by name."""

import dataclasses

import pytest

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.models import get_model

#: the vae_types of tests/test_registry.py, plus its fallback and
#: first-digit cases
VAE_TYPES = [
    "reg_vae1", "reg_vae2_mask_augm", "vanilla_vae3", "vanilla_vae1_mask_augm",
    "vanilla_vae2_with_drop", "vanilla_vae1_with_drop_mask_augm", "reg_EDDI1",
    "vanilla_EDDI2", "vanilla_EDDI3_with_drop", "reg_EDDI_mnist1",
    "vanilla_EDDI_mnist1", "reg_flow1", "vanilla_flow2", "reg_notMIWAE1",
    "vanilla_notMIWAE1", "reg_MIWAE3", "vanilla_MIWAE1", "mystery_model7",
    "reg_vae12",
]


@pytest.mark.parametrize("vae_type", VAE_TYPES)
def test_parse_vae_type_matches_jax(vae_type):
    got = dataclasses.asdict(tcfg.parse_vae_type(vae_type))
    want = dataclasses.asdict(jcfg.parse_vae_type(vae_type))
    assert got == want


def test_family_precedence_matches_jax():
    assert tcfg.FAMILY_PRECEDENCE == jcfg.FAMILY_PRECEDENCE


def test_run_config_defaults_match_jax():
    port = tcfg.RunConfig()
    ref = jcfg.RunConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.info == tcfg.parse_vae_type(ref.vae_type)


@pytest.mark.parametrize("vae_type,regularized", [
    ("reg_vae1", True), ("vanilla_vae1", False), ("reg_EDDI1", True),
    ("vanilla_EDDI2", False)])
def test_get_model_routes_gauss(vae_type, regularized):
    model = get_model(tcfg.RunConfig(vae_type=vae_type))
    assert model.name == "gauss"
    assert model.uses_p_branch is regularized


@pytest.mark.parametrize("vae_type,slice_name", [
    ("reg_flow1", "flow"), ("vanilla_flow2", "flow"),
    ("reg_MIWAE1", "importance-weighted"),
    ("vanilla_notMIWAE1", "importance-weighted")])
def test_get_model_names_the_slice_of_unported_families(vae_type, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        get_model(tcfg.RunConfig(vae_type=vae_type))


def test_compute_dtype():
    with pytest.raises(NotImplementedError, match="mixed-precision slice"):
        get_model(tcfg.RunConfig(compute_dtype="bfloat16"))
    with pytest.raises(ValueError):
        get_model(tcfg.RunConfig(compute_dtype="bf16"))
