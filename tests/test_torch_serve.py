"""The port's ImputationServer against the JAX package's: fed the JAX
server's eps, it returns the same imputations and row scores, for the MNIST
reg_EDDI1 widths and for the trained MNIST checkpoint; plus bucketing,
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
from vae_posterior_consistency_tpu.models import gauss as jgauss
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.engine import serve as tserve

KW = dict(vae_type="reg_EDDI1", data_type="mnist", seed=3)


def _jax_noise(seed):
    """The JAX server's eps for request `ctr`: its key is
    fold_in(PRNGKey(seed + 9), ctr) (engine/serve.py) and eval_step's
    reparameterize draws normal(key, [bucket, latent_dim])."""
    base = jax.random.PRNGKey(seed + 9)

    def noise(ctr, shape):
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(base, np.uint32(ctr)), shape)))

    return noise


def _servers(D=20, buckets=(4, 16)):
    jc = jcfg.RunConfig(**KW)
    jparams = jgauss.init(jax.random.PRNGKey(0), jc, D)
    tparams = tckpt.params_from_jax(jckpt._flatten(jparams), "cpu")
    jsrv = jserve.ImputationServer(jparams, jc, D, buckets=buckets)
    tsrv = tserve.ImputationServer(tparams, tcfg.RunConfig(**KW), D,
                                   buckets=buckets, device="cpu",
                                   noise=_jax_noise(jc.seed))
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


def test_trained_mnist_checkpoint_serves_like_jax():
    jc, tc = jcfg.RunConfig(**KW, missing_rate=30), tcfg.RunConfig(
        **KW, missing_rate=30)
    path = tckpt.checkpoint_path(tc)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    jsrv = jserve.ImputationServer(convert_state_dict(sd, jc, 784), jc, 784,
                                   buckets=(8,))
    tsrv = tserve.ImputationServer(tckpt.load_reference(path, tc, 784, "cpu"),
                                   tc, 784, buckets=(8,), device="cpu",
                                   noise=_jax_noise(jc.seed))
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
