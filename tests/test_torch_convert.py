"""The port's reference-checkpoint converter against the JAX package's tool
(tools/convert_reference_checkpoint.py), for every family both ways: a
reference-named state_dict maps to the same arrays bit for bit, the port's
export writes the same tensors in the same dtypes, the refusals and the
leaves filled from a fresh init are the tool's, and the port's CLI runs
both ways."""

import ast
import re

import jax
import numpy as np
import pytest
import torch

from tools import convert_reference_checkpoint as jtool
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.tools import (
    convert_reference_checkpoint as ttool,
)

OBS = 7
#: small widths: the flow's trunk is hid_dim wide, the EDDI embed K wide
SMALL = dict(latent_dim=4, hid_dim=16, K=5)
CASES = {
    "vanilla_vae1": dict(vae_type="vanilla_vae1"),
    "reg_EDDI1": dict(vae_type="reg_EDDI1"),
    "vanilla_MIWAE1": dict(vae_type="vanilla_MIWAE1"),
    "reg_MIWAE1": dict(vae_type="reg_MIWAE1"),
    "vanilla_notMIWAE1": dict(vae_type="vanilla_notMIWAE1"),
    "vanilla_notMIWAE1_author": dict(vae_type="vanilla_notMIWAE1",
                                     not_miwae_type="author"),
    "reg_notMIWAE1": dict(vae_type="reg_notMIWAE1"),
    "reg_notMIWAE1_author": dict(vae_type="reg_notMIWAE1",
                                 not_miwae_type="author"),
    "reg_flow1": dict(vae_type="reg_flow1"),
    "reg_flow1_actnorm": dict(vae_type="reg_flow1", flow_actnorm=True),
}


def _configs(name):
    kw = dict(CASES[name], **SMALL)
    return jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)


def _jax_params(jc):
    """JAX-initialised parameters, seeded by the case, with every leaf
    moved off its init (an ActNorm starts at the identity)."""
    params = jget_model(jc).init(jax.random.PRNGKey(7), jc, OBS)
    rng = np.random.default_rng(7)
    return {k: np.asarray(v) + rng.standard_normal(np.shape(v)).astype(
        np.float32) * 0.01 for k, v in jckpt._flatten(params).items()}


def _nested(flat):
    return tckpt.unflatten(dict(flat))


def _filled(capsys):
    """The leaves a converter's notice says it kept at fresh init, as the
    port's slash keys (JAX prints tree paths, "['actnorm'][0]['shift']")."""
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if "kept at fresh init" in s]
    if not line:
        return set()
    names = ast.literal_eval(line[0].split("kept at fresh init: ", 1)[1])
    return {"/".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]",
                                                 k)) if k.startswith("[")
            else k for k in names}


def _assert_same_state_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_every_family_converts_and_exports_as_the_jax_tool(name, capsys):
    jc, tc = _configs(name)
    flat = _jax_params(jc)
    jparams = jax.tree_util.tree_map(np.asarray, _nested(flat))
    sd = jtool.export_state_dict(jparams, jc, OBS)

    # the port's export of the same parameters: every tensor, every dtype
    _assert_same_state_dicts(
        tckpt.export_state_dict(tckpt.params_from_jax(flat, "cpu"), tc, OBS),
        sd)

    # the state_dict back into parameters: the JAX tool's arrays, bit for
    # bit, and the same leaves kept at fresh init
    capsys.readouterr()
    want = jckpt._flatten(jtool.convert_state_dict(dict(sd), jc, OBS))
    want_filled = _filled(capsys)
    got = tckpt.flatten(tckpt.convert_state_dict(dict(sd), tc, OBS))
    got_filled = _filled(capsys)
    assert got_filled == want_filled
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        if k not in want_filled:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    if jc.flow_actnorm:
        assert {k for k in want_filled if k.startswith("actnorm/")}
    if "notMIWAE" in jc.vae_type and not jc.info.regularized:
        assert {"logits_lin/w", "logits_lin/b"} <= got_filled

    # the refusals: an unread tensor, a width the model does not have, a
    # leaf the model does not know
    stray = dict(sd, **{"stray.weight": torch.zeros(2, 2)})
    for conv, cfg in ((jtool.convert_state_dict, jc),
                      (tckpt.convert_state_dict, tc)):
        with pytest.raises(ValueError, match="not consumed"):
            conv(stray, cfg, OBS)
        with pytest.raises(ValueError, match="shape mismatch"):
            conv(dict(sd), cfg, OBS + 1)
    # one Linear more in the decoder's Sequential
    n = sum(k.startswith("seq_decoder.") and k.endswith(".weight")
            for k in sd)
    extra = dict(sd, **{f"seq_decoder.{2 * n}.weight": torch.zeros(OBS, OBS),
                        f"seq_decoder.{2 * n}.bias": torch.zeros(OBS)})
    for conv, cfg in ((jtool.convert_state_dict, jc),
                      (tckpt.convert_state_dict, tc)):
        with pytest.raises(ValueError, match="unknown to the model"):
            conv(dict(extra), cfg, OBS)


@pytest.mark.parametrize("name", ["reg_EDDI1", "reg_notMIWAE1_author",
                                  "reg_flow1"])
def test_the_cli_converts_both_ways(name, tmp_path, monkeypatch, capsys):
    """The port's tool from a reference state_dict to a checkpoint at the
    mangled default path (the JAX package's loader reads it), and
    `--reverse` back to the JAX tool's state_dict."""
    jc, tc = _configs(name)
    flat = _jax_params(jc)
    sd = jtool.export_state_dict(
        jax.tree_util.tree_map(np.asarray, _nested(flat)), jc, OBS)
    ref = tmp_path / "reference.pt"
    torch.save(sd, ref)
    monkeypatch.chdir(tmp_path)
    flags = ["--vae_type", jc.vae_type, "--obs_dim", str(OBS),
             "--latent_dim", str(SMALL["latent_dim"]),
             "--hid_dim", str(SMALL["hid_dim"]), "--K", str(SMALL["K"]),
             "--not_miwae_type", jc.not_miwae_type,
             "--missing_rate", str(jc.missing_rate)]
    ttool.main(["--checkpoint", str(ref), *flags])
    assert "converted" in capsys.readouterr().out
    out = tmp_path / tckpt.checkpoint_path(tc)
    assert tckpt.checkpoint_path(tc) == jckpt.checkpoint_path(jc)
    written = torch.load(out, weights_only=False)
    template = jget_model(jc).init(jax.random.PRNGKey(0), jc, OBS)
    back = jckpt._flatten(jckpt.load(template, str(out)))
    assert sorted(written) == sorted(back)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    ttool.main(["--checkpoint", str(out), "--reverse", *flags,
                "--out", str(tmp_path / "again.pt")])
    assert "exported" in capsys.readouterr().out
    _assert_same_state_dicts(torch.load(tmp_path / "again.pt"), sd)
    ttool.main(["--checkpoint", str(out), "--reverse", *flags])
    _assert_same_state_dicts(torch.load(str(out) + ".reference.pt"), sd)
