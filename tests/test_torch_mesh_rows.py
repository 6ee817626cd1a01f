"""The row helpers every mesh path of slice 10 part 2 shares
(`parallel/mesh.padded_rows`, `Rows`, `rows_of`, `RankRows`) against the
JAX package's padding rules, in one process: a dp rank is a stand-in mesh
that answers its shape, its dp coordinate and its device (`FakeMesh`), so
no process group is needed.

The rules held: the ensembles' replica padding (the last seed, alpha or
row repeated, `sweep.py:439-441`) and `shard_ensemble`'s refusal, the AL
test rows' zero padding and weights (`_pad_rows_for_mesh`), the AIS
chains' B0_run (`_prep_chains`), the server's buckets (`serve.py:44`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import active_learning as jal
from vae_posterior_consistency_tpu.engine import ais as jais
from vae_posterior_consistency_tpu.engine import serve as jserve
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu.parallel import sweep as jsweep
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import active_learning as tal
from vae_posterior_consistency_tpu_torch.engine import ais as tais
from vae_posterior_consistency_tpu_torch.engine import serve as tserve
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import mesh as tmesh
from vae_posterior_consistency_tpu_torch.parallel import sweep as tsweep

from test_torch_ais import JaxChainKeys
from test_torch_parallel import _jmesh


class FakeMesh:
    """dp rank `r` of a (dp, 1) mesh on the CPU, without a process group:
    the shape, the coordinate and the device, which is all a rank's rows
    need (its gathers are not called here)."""

    def __init__(self, dp, r):
        self.shape, self._r = {"dp": dp, "tp": 1}, r
        self.device = torch.device("cpu")

    def rank(self, axis):
        return self._r if axis == "dp" else 0

    def group(self, axis):
        return None


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 3, 4, 7, 17])
def test_padded_rows_and_blocks_follow_jax_s_rule(n, dp):
    """padded = -(-n // dp) * dp; rank r's block is rows [r * padded / dp,
    (r + 1) * padded / dp), the blocks tile the padded axis in rank order,
    and `take` cuts that block along any axis."""
    padded = tmesh.padded_rows(n, dp)
    assert padded == -(-n // dp) * dp and padded % dp == 0
    assert padded - n < dp
    table = torch.arange(padded * 3).reshape(3, padded)
    blocks = []
    for r in range(dp):
        rows = tmesh.rows_of(FakeMesh(dp, r), n)
        assert (rows.n, rows.padded, rows.local) == (n, padded, padded // dp)
        blocks.append(rows.take(table, axis=1))
    assert torch.equal(torch.cat(blocks, dim=1), table)


def test_one_rank_rows_gather_to_the_real_rows():
    """Off a mesh and on one rank a gather is the identity, cut to the
    real rows."""
    t = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(tmesh.rows_of(None, 4).gather(t), t[:4])
    rows = tmesh.rows_of(None, 4, padded=6)
    assert torch.equal(rows.gather(t), t[:4])
    assert torch.equal(rows.gather(t, cut=False), t)
    assert torch.equal(rows.take(t), t)


class _Source:
    """A noise source whose draws are their global positions."""

    def __init__(self):
        self.asked = []

    def __call__(self, kind, step, shape):
        self.asked.append((kind, tuple(shape)))
        return torch.arange(int(np.prod(shape))).reshape(shape)

    def epoch(self, epoch, n, steps, shapes):
        return {"perm": torch.arange(4 * n).reshape(4, n),
                "eps": torch.arange(steps * 4 * 3).reshape(steps, 4, 3),
                "shared": torch.arange(5)}


@pytest.mark.parametrize("r", [0, 1])
def test_rank_rows_draw_the_global_shape_and_keep_the_rank_s_block(r):
    """Asked for its [3, 2] rows along axis 0 on dp = 2, a rank draws
    [6, 2] and keeps its block; along axis 1 likewise; a shared kind (axis
    None) passes through whole and a kind missing from the table raises;
    an ensemble source's epoch draws are cut per key."""
    src = _Source()
    ranked = tmesh.RankRows(src, {"a": 0, "b": 1, "c": None}, 2, r)
    full = torch.arange(12).reshape(6, 2)
    assert torch.equal(ranked("a", 0, (3, 2)), full[3 * r:3 * r + 3])
    full_b = torch.arange(12).reshape(2, 6)
    assert torch.equal(ranked("b", 0, (2, 3)), full_b[:, 3 * r:3 * r + 3])
    assert torch.equal(ranked("c", 0, (4,)), torch.arange(4))
    assert src.asked == [("a", (6, 2)), ("b", (2, 6)), ("c", (4,))]
    with pytest.raises(KeyError, match="'d' has no row axis"):
        ranked("d", 0, (4,))
    with pytest.raises(KeyError, match="'shared' has no row axis"):
        tmesh.RankRows(src, {"perm": 0, "eps": 1}, 2, r).epoch(0, 5, 2, {})
    ens = tmesh.RankRows(src, {"perm": 0, "eps": 1, "shared": None}, 2,
                         r).epoch(0, 5, 2, {})
    assert torch.equal(ens["perm"], torch.arange(20).reshape(4, 5)[2 * r:
                                                                 2 * r + 2])
    assert torch.equal(ens["eps"], torch.arange(24).reshape(2, 4, 3)[
        :, 2 * r:2 * r + 2])
    assert torch.equal(ens["shared"], torch.arange(5))


@pytest.mark.parametrize("S,dp", [(3, 2), (4, 2), (5, 4), (6, 4), (1, 2)])
def test_ensemble_padding_repeats_the_last_row_as_jax_does(S, dp):
    """The seeds, alphas and sweep rows pad to a multiple of dp by
    repeating the last (sweep.py:439-441, 666-668, 801-803)."""
    values = list(range(10, 10 + S))
    rows = tmesh.rows_of(FakeMesh(dp, 0), S)
    assert tsweep._padded(values, rows) == values + [values[-1]] * (
        (-S) % dp)


@pytest.mark.parametrize("S,dp", [(3, 2), (4, 2), (8, 4)])
def test_shard_ensemble_refuses_what_jax_refuses_and_cuts_the_rows(S, dp):
    """`shard_ensemble` raises JAX's ValueError when S does not divide
    over dp, and otherwise hands rank r its S/dp rows of every leaf."""
    params = {"w": torch.arange(S * 2.0).reshape(S, 2)}
    if S % dp:
        with pytest.raises(ValueError) as want:
            jsweep.shard_ensemble({"w": jnp.zeros((S, 2))}, None,
                                  _jmesh(dp, 1))
        with pytest.raises(ValueError, match=str(want.value)):
            tsweep.shard_ensemble(params, None, FakeMesh(dp, 0))
        return
    b = S // dp
    for r in range(dp):
        got, state = tsweep.shard_ensemble(params, None, FakeMesh(dp, r))
        assert state is None
        assert torch.equal(got["w"], params["w"][r * b:(r + 1) * b])


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("n", [5, 8])
def test_al_rows_pad_with_zero_rows_weighted_out_as_jax_s(n, dp):
    """The episode's test rows: zero rows up to a multiple of dp, weight 1
    on a real row and 0 on a padded one (`_pad_rows_for_mesh`), each rank
    holding its block of both."""
    D = 4
    x = np.random.default_rng(0).uniform(size=(n, D)).astype(np.float32)
    jx, _, n_run, w = jal._pad_rows_for_mesh(
        jnp.asarray(x), jnp.ones((n, D)), n, D, FakeMesh(dp, 0))
    w = np.ones(n_run, np.float32) if w is None else np.asarray(w)
    tc = tcfg.RunConfig(vae_type="vanilla_vae1", M=2)
    b = n_run // dp
    for r in range(dp):
        rows, x_r, w_r, _ = tal._episode_rows(
            torch.from_numpy(x), tc, FakeMesh(dp, r), lambda *a: None)
        assert rows.padded == n_run
        np.testing.assert_array_equal(x_r.numpy(),
                                      np.asarray(jx)[r * b:(r + 1) * b])
        np.testing.assert_array_equal(w_r.numpy(), w[r * b:(r + 1) * b])


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("B0,n_sample", [(3, 3), (2, 3), (5, 2), (4, 4)])
def test_ais_chains_pad_rows_until_they_divide_as_jax_s(B0, n_sample, dp):
    """B0_run grows from B0 until B0_run * n_sample divides over dp, the
    padded rows zero (`_prep_chains`); rank r's chains are its block of
    JAX's x_rep and z0 under JAX's keys."""
    L, D, T = 3, 4, 3
    x = np.random.default_rng(1).uniform(size=(B0, D)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jx_rep, jz0, _, B0_run = jais._prep_chains(
        jnp.asarray(x), n_sample, L, jnp.zeros(T), key, _jmesh(dp, 1))
    assert (B0_run * n_sample) % dp == 0 and B0_run - B0 < dp
    b = B0_run * n_sample // dp
    for r in range(dp):
        ch = tais._prep_chains(torch.from_numpy(x), n_sample, L,
                               JaxChainKeys(key, T), mesh=FakeMesh(dp, r))
        assert ch.B0_run == B0_run and ch.rows.padded == B0_run * n_sample
        np.testing.assert_array_equal(ch.x_rep.numpy(),
                                      np.asarray(jx_rep)[r * b:(r + 1) * b])
        np.testing.assert_array_equal(ch.z0.numpy(),
                                      np.asarray(jz0)[r * b:(r + 1) * b])


@pytest.mark.parametrize("dp", [2, 3, 4])
def test_server_buckets_round_up_to_dp_as_jax_s(dp):
    kw = dict(vae_type="reg_vae1", latent_dim=2)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jp = jget_model(jc).init(jax.random.PRNGKey(0), jc, 5)
    tp = get_model(tc).init(torch.Generator().manual_seed(0), tc, 5,
                            device="cpu")
    want = jserve.ImputationServer(jp, jc, 5, mesh=_jmesh(dp, 1)).buckets
    got = tserve.ImputationServer(tp, tc, 5, mesh=FakeMesh(dp, 0)).buckets
    assert got == want == tuple(sorted({-(-b // dp) * dp for b in
                                        tserve.DEFAULT_BUCKETS}))


def test_a_follower_drops_a_request_rank_0_answers_with_a_400(monkeypatch):
    """A follower rank imputes each request rank 0 broadcasts; one that
    raises what rank 0's handler turns into a 400 is dropped, and the
    follower goes on to the next until the stop message, so the ranks
    stay in step."""
    tc = tcfg.RunConfig(vae_type="reg_vae1", latent_dim=2)
    tp = get_model(tc).init(torch.Generator().manual_seed(0), tc, 5,
                            device="cpu")
    srv = tserve.ImputationServer(tp, tc, 5, device="cpu")
    x = np.zeros((1, 5), np.float32)
    msgs = iter([(x[:, :4], x[:, :4]), (x, np.ones_like(x)), None])
    monkeypatch.setattr(tserve, "_broadcast", lambda obj: next(msgs))
    assert srv.follow() == 1
