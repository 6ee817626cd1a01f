"""Imputation serving: a bucketed, fixed-shape inference path and a stdlib
HTTP endpoint (port of the JAX package's `engine/serve.py`).

- `ImputationServer.impute(x, mask)` pads each request up to one of a fixed
  set of batch sizes, runs the model's `eval_step` on the server's device,
  and returns the imputation (observed cells kept verbatim) and a per-row
  score: the negative evidence bound (lower = better fit).
- `make_http_server` / `serve_http`: POST /impute with JSON
  {"x": [[...]], "mask": [[...]]}.

It serves every family. A request draws the family's evaluation noise,
`ModelDef.eval_noise(cfg, bucket, D)` without "mask_p": the server hands
`eval_step` an all-ones `mask_p`, as the JAX server does. That is "eps",
standard normals of [bucket, latent_dim] for gauss and the flow,
[bucket, valid_k, latent_dim] for notMIWAE and a vanilla MIWAE type, and
[2, bucket, valid_k, latent_dim] for a regularized MIWAE type's q and p
branches (K = cfg.valid_k, as the JAX `eval_step` takes it). The noise comes
from a `torch.Generator` on the server's device seeded with `cfg.seed + 9`,
as the JAX server seeds its key. A caller may pass its own noise source
instead: `noise(kind, ctr, shape)` returns the draw of `kind`, a float32
tensor of `shape`, for request number `ctr` (1, 2, ...).

Mesh (the JAX package's engine/serve.py:38-48, 104-106). With a (dp, tp)
mesh the parameters are replicated and the request rows dp-sharded: the
buckets are rounded up to multiples of dp (`-(-b // dp) * dp`, so a 1-row
request on dp = 2 takes bucket 2), each dp rank imputes its block of the
padded rows (the tp ranks of one dp index repeat it) from the draws of the
whole bucket cut to its rows (`parallel/mesh.RankRows`), and the blocks are
all-gathered, so `impute` is a collective that every rank calls with the
same request and that returns the whole result on every rank. Over HTTP
(`serve_http`) on two ranks or more, rank 0 listens and broadcasts each
request to the other ranks, which wait for it in `follow` until the stop
message (`stop_followers`).
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch
import torch.distributed as dist

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib
from vae_posterior_consistency_tpu_torch.utils import tracing

DEFAULT_BUCKETS = (1, 8, 64, 512)


class GeneratorNoise:
    """Standard-normal eps from a seeded `torch.Generator` on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, kind: str, ctr: int, shape):
        # every kind a server draws is standard normal; the generator's own
        # state advances draw by draw
        del kind, ctr
        return torch.randn(shape, generator=self.generator, device=self.device)


class ImputationServer:
    def __init__(self, params, cfg: RunConfig, obs_dim: int,
                 buckets=DEFAULT_BUCKETS, device="cuda", noise=None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            buckets = {meshlib.padded_rows(b, mesh.shape["dp"])
                       for b in buckets}
            device = mesh.device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ImputationServer: CUDA is not available; "
                               "pass device='cpu' to serve on the CPU")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.obs_dim = obs_dim
        self.buckets = tuple(sorted(buckets))
        self.params = checkpoint.on_device(params, self.device)
        self._noise = (GeneratorNoise(cfg.seed + 9, self.device)
                       if noise is None else noise)
        # itertools counters are atomic under the GIL, so concurrent
        # impute() callers never share a request number
        self._ctr = itertools.count(1)

    def warmup(self):
        """Run every bucket shape once."""
        for b in self.buckets:
            self.impute(np.zeros((b, self.obs_dim), np.float32),
                        np.ones((b, self.obs_dim), np.float32))
        return self

    def check(self, x, mask):
        """(x, mask) as float32 arrays; ValueError unless both are [n, D]."""
        x = np.asarray(x, np.float32)
        mask = np.asarray(mask, np.float32)
        if x.ndim != 2 or x.shape != mask.shape or x.shape[1] != self.obs_dim:
            raise ValueError(f"impute: want x and mask [n, {self.obs_dim}], "
                             f"got {x.shape} and {mask.shape}")
        return x, mask

    def impute(self, x, mask):
        """Impute missing cells; returns (filled [n,D], row_score [n]) as
        numpy arrays, where row_score is the per-row negative evidence bound.
        On a mesh every rank calls it with the same request and gets the
        whole result.
        """
        with tracing.span("serve.impute") as sp:
            x, mask = self.check(x, mask)
            n = x.shape[0]
            bucket = next((b for b in self.buckets if b >= n), None)
            if bucket is None:
                bucket = ((n + self.buckets[-1] - 1) // self.buckets[-1]
                          ) * self.buckets[-1]
            sp.set(rows=n, bucket=bucket)
            ctr = next(self._ctr)
            rows = meshlib.rows_of(self.mesh, n, padded=bucket)
            noise = self._noise
            if rows.dp > 1:
                noise = meshlib.RankRows(noise, self.model.eval_noise_rows(
                    self.cfg), rows.dp, rows.r)
            drawn = {}
            with tracing.span("serve.draw"):
                for kind, shape in self.model.eval_noise(
                        self.cfg, rows.local, self.obs_dim).items():
                    if kind == "mask_p":
                        continue
                    t = noise(kind, ctr, shape)
                    if (tuple(t.shape) != tuple(shape)
                            or t.dtype != torch.float32):
                        raise ValueError(
                            f"noise source gave {kind} {t.dtype} "
                            f"{tuple(t.shape)}, want float32 {shape}")
                    drawn[kind] = t.to(self.device)
            with torch.inference_mode():
                with tracing.span("serve.copy_in"):
                    x_t = rows.take(rows.pad(
                        torch.from_numpy(x).to(self.device)))
                    m_t = rows.take(rows.pad(
                        torch.from_numpy(mask).to(self.device), 1.0))
                with tracing.span("model.eval_step"):
                    out = self.model.eval_step(self.params, x_t, m_t,
                                               torch.ones_like(m_t),
                                               drawn["eps"], self.cfg)
                # fill only the missing cells; keep observed values verbatim
                filled = x_t * m_t + out["x_imputed"] * (1.0 - m_t)
                # quality score: the per-row negative evidence bound
                both = torch.cat([filled, out["row_loss"][:, None]], dim=1)
                with tracing.span("serve.copy_out"):
                    both = rows.gather(both).cpu().numpy()  # one host copy
                    tracing.count("host_reads")
        return both[:, :-1], both[:, -1]

    @property
    def spread(self) -> bool:
        """Whether requests must reach other ranks (a mesh of two ranks or
        more)."""
        return (self.mesh is not None and dist.is_initialized()
                and dist.get_world_size() > 1)

    def follow(self) -> int:
        """On a rank other than 0 of a mesh: take each request rank 0
        broadcasts and impute it, until the stop message; returns the
        number of requests served. A request that raises what rank 0's
        handler answers with a 400 is dropped here too, so the ranks stay in
        step."""
        served = 0
        while True:
            msg = _broadcast(None)
            if msg is None:
                return served
            try:
                self.impute(*msg)
            except BAD_REQUEST:
                continue
            served += 1


#: what the HTTP handler answers with a 400 (and a follower drops)
BAD_REQUEST = (KeyError, ValueError, json.JSONDecodeError)


def _broadcast(obj):
    """`obj` from rank 0 on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def stop_followers(server: ImputationServer) -> None:
    """On rank 0: end the other ranks' `follow` loops."""
    if server.spread:
        _broadcast(None)


def make_http_server(server: ImputationServer, host: str = "127.0.0.1",
                     port: int = 8787):
    """Build (but don't run) the HTTP endpoint; returns the bound
    ThreadingHTTPServer. `port=0` binds a free port chosen by the OS (read
    it back from `httpd.server_address[1]`). On a mesh of two ranks or more
    it runs on rank 0, each request broadcast to the other ranks, which
    `follow`; `stop_followers` ends them."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    impute_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/impute":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length))
                with impute_lock:
                    x, mask = server.check(payload["x"], payload["mask"])
                    if server.spread:
                        _broadcast((x, mask))
                    filled, negll = server.impute(x, mask)
                body = json.dumps(
                    {"imputed": filled.tolist(), "row_score": negll.tolist()}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            except BAD_REQUEST as e:
                self.send_error(400, str(e))

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(server: ImputationServer, host: str = "127.0.0.1",
               port: int = 8787):
    """Minimal HTTP endpoint: POST /impute {"x": ..., "mask": ...}. Threaded
    accept loop; device work is serialized through a lock. On a mesh of
    two ranks or more every rank calls it: rank 0 listens, the others
    follow its requests until it stops."""
    if server.spread and dist.get_rank() != 0:
        server.follow()
        return
    httpd = make_http_server(server, host, port)
    print(f"imputation server on http://{host}:{httpd.server_address[1]}"
          "/impute")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        stop_followers(server)
