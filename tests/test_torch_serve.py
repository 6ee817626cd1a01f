"""The port's ImputationServer against the JAX package's: fed the JAX
server's eps, it returns the same imputations and row scores, for the MNIST
reg_EDDI1 widths, for the trained MNIST checkpoint and for every other
family at the wine width (MIWAE vanilla and regularized, notMIWAE, the flow
with ActNorm); a request's rows are served independently; plus bucketing,
padding, the HTTP endpoint and device handling."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tools.convert_reference_checkpoint import convert_state_dict
from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import serve as jserve
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import serve as tserve
from test_torch_evaluate import JaxEvalKeys
from test_torch_flow_vae import _random_actnorm

KW = dict(vae_type="reg_EDDI1", data_type="mnist", seed=3)
#: the other families at the wine width, narrow (the MIWAE and notMIWAE
#: widths are fixed; hid_dim sets the flow's), with few importance samples
FAMILIES = {
    "vanilla_MIWAE1": dict(vae_type="vanilla_MIWAE1"),
    "reg_MIWAE1": dict(vae_type="reg_MIWAE1"),
    "vanilla_notMIWAE1": dict(vae_type="vanilla_notMIWAE1"),
    "reg_flow1_actnorm": dict(vae_type="reg_flow1", flow_actnorm=True),
}
WINE_KW = dict(data_type="wine", seed=3, latent_dim=4, hid_dim=16, valid_k=6)


def _jax_noise(tc):
    """The JAX server's draws for request `ctr`: its key is
    fold_in(PRNGKey(seed + 9), ctr) (engine/serve.py), from which the
    family's eval_step draws its eps (JaxEvalKeys.eps)."""
    base = jax.random.PRNGKey(tc.seed + 9)
    keys = JaxEvalKeys(None, tc)

    def noise(kind, ctr, shape):
        assert kind == "eps", kind
        return keys.eps(jax.random.fold_in(base, np.uint32(ctr)), shape)

    return noise


def _servers(D=20, buckets=(4, 16), kw=KW):
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jparams = jget_model(jc).init(jax.random.PRNGKey(0), jc, D)
    if jc.flow_actnorm:
        jparams = _random_actnorm(jparams, jc.latent_dim)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    jsrv = jserve.ImputationServer(jparams, jc, D, buckets=buckets)
    tsrv = tserve.ImputationServer(tparams, tc, D, buckets=buckets,
                                   device="cpu", noise=_jax_noise(tc))
    return jsrv, tsrv


def _check_same(jsrv, tsrv, x, mask):
    f_t, s_t = tsrv.impute(x, mask)
    f_j, s_j = jsrv.impute(x, mask)
    assert f_t.shape == x.shape and s_t.shape == (x.shape[0],)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(f_t * mask, x * mask)


def test_impute_matches_jax_server_across_buckets():
    jsrv, tsrv = _servers()
    rng = np.random.default_rng(0)
    # request counters advance in step, so request i gets the same eps
    for n in (1, 3, 9, 33):  # buckets 4, 4, 16, and 48 (past the largest)
        x = rng.uniform(0, 1, (n, 20)).astype(np.float32)
        mask = (rng.random((n, 20)) < 0.7).astype(np.float32)
        _check_same(jsrv, tsrv, x * mask, mask)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_serves_like_jax(family):
    """K = valid_k importance samples a row for MIWAE and notMIWAE, the q
    and p branches of reg_MIWAE1 under an all-ones mask_p, the flow's
    ActNorm list of parameters."""
    jsrv, tsrv = _servers(13, kw=dict(**WINE_KW, **FAMILIES[family]))
    rng = np.random.default_rng(2)
    for n in (3, 9, 20):  # buckets 4, 16, and 32 (past the largest)
        x = rng.uniform(0, 1, (n, 13)).astype(np.float32)
        mask = (rng.random((n, 13)) < 0.7).astype(np.float32)
        _check_same(jsrv, tsrv, x * mask, mask)


@pytest.mark.parametrize("family", ["reg_EDDI1", *FAMILIES])
def test_a_row_moves_only_its_own_output(family):
    """Two servers, same parameters: the second request differs from the
    first in one row, its cells and its noise. Every other row's output
    stays the same, and that row's moves. Noise shared across a request's
    rows (eps broadcast to [B, B, L]) would move them all."""
    kw = (dict(KW, data_type="wine") if family == "reg_EDDI1"
          else dict(**WINE_KW, **FAMILIES[family]))
    _, tsrv = _servers(13, kw=kw)
    base = _jax_noise(tsrv.cfg)

    def changed(kind, ctr, shape):
        eps = base(kind, ctr, shape).clone()
        idx = (slice(None), 2) if eps.ndim == 4 else (2,)
        eps[idx] = -eps[idx]
        return eps

    other = tserve.ImputationServer(tsrv.params, tsrv.cfg, 13,
                                    buckets=tsrv.buckets, device="cpu",
                                    noise=changed)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (6, 13)).astype(np.float32)
    mask = (rng.random((6, 13)) < 0.7).astype(np.float32)
    x2 = x.copy()
    x2[2] = rng.uniform(0, 1, 13).astype(np.float32) * mask[2]
    f1, s1 = tsrv.impute(x * mask, mask)
    f2, s2 = other.impute(x2 * mask, mask)
    rest = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(f2[rest], f1[rest])
    np.testing.assert_array_equal(s2[rest], s1[rest])
    assert s2[2] != s1[2]


def test_trained_mnist_checkpoint_serves_like_jax():
    jc, tc = jcfg.RunConfig(**KW, missing_rate=30), tcfg.RunConfig(
        **KW, missing_rate=30)
    path = tckpt.checkpoint_path(tc)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    jsrv = jserve.ImputationServer(convert_state_dict(sd, jc, 784), jc, 784,
                                   buckets=(8,))
    tsrv = tserve.ImputationServer(tckpt.load_reference(path, tc, 784, "cpu"),
                                   tc, 784, buckets=(8,), device="cpu",
                                   noise=_jax_noise(tc))
    test = tloaders.data_loader_mnist("Data", tc.vae_type, 30, 8,
                                      device="cpu").test
    x, mask = test.x[:5].numpy(), test.mask[:5].numpy()
    _check_same(jsrv, tsrv, x * mask, mask)


def test_default_noise_is_seeded_and_observed_cells_kept():
    _, tsrv = _servers()
    srv2 = tserve.ImputationServer(tsrv.params, tsrv.cfg, 20, buckets=(4, 16),
                                   device="cpu")
    srv3 = tserve.ImputationServer(tsrv.params, tsrv.cfg, 20, buckets=(4, 16),
                                   device="cpu")
    x = np.random.default_rng(1).uniform(0, 1, (5, 20)).astype(np.float32)
    mask = np.ones_like(x)
    mask[:, 3] = 0.0
    f2, s2 = srv2.impute(x, mask)
    f3, s3 = srv3.impute(x, mask)
    np.testing.assert_array_equal(f2, f3)
    np.testing.assert_array_equal(s2, s3)
    np.testing.assert_array_equal(f2 * mask, x * mask)
    assert np.all((f2[:, 3] > 0) & (f2[:, 3] < 1))  # sigmoid decoder
    with pytest.raises(ValueError):
        srv2.impute(x[:, :7], mask[:, :7])


def test_cuda_server_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tsrv = _servers()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.ImputationServer(tsrv.params, tsrv.cfg, 20)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_round_trip_and_errors():
    _, tsrv = _servers()
    httpd = tserve.make_http_server(tsrv, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        mask = [[1] * 20, [1, 0] * 10]
        out = _post(port, "/impute",
                    json.dumps({"x": [[0.5] * 20] * 2, "mask": mask}).encode())
        assert np.asarray(out["imputed"]).shape == (2, 20)
        assert len(out["row_score"]) == 2
        for path, body, code in (("/impute", b"{not json", 400),
                                 ("/impute", b'{"x": [[0.5]]}', 400),
                                 ("/nope", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, path, body)
            assert e.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()
