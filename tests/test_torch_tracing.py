"""The port's in-program tracer, `utils/tracing`: nothing recorded while no
torch profiler records; nesting, parents and one root a request under one;
thread-local stacks; counter events; the cap; one clock with the
profiler's events; the spans merged into `profile_trace`'s Chrome trace
(and an entry point's `-profile DIR`); and the spans and counters of the
evaluator, the server, the trainer, the AL engine, the MIWAE model, the
MNAR evaluator and the notMIWAE model on the CPU."""

import collections
import contextlib
import json
import os
import shutil
import threading
import time

import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data import loaders
from vae_posterior_consistency_tpu_torch.engine import (
    active_learning,
    checkpoint,
    evaluate,
    serve,
    train,
)
from vae_posterior_consistency_tpu_torch.experiment_main import (
    imputation,
    imputation_mnar,
)
from vae_posterior_consistency_tpu_torch.models import (
    get_model,
    miwae,
    notmiwae,
)
from vae_posterior_consistency_tpu_torch.utils import logging, tracing
from cli_harness import REPO

#: how far a span opened around a `record_function` range may start after,
#: or end before, the range's kineto event: the two are stamped by
#: `time.time_ns()` and by the profiler's clock converted to Unix time. On
#: this CPU, over 500 ranges, the span started at least 2.5 us before the
#: range and ended at least 1.3 us after it; the tolerance allows for the
#: converter's error on a slower host.
CLOCK_TOL_NS = 10_000


@pytest.fixture(autouse=True)
def clean():
    tracing.take()
    yield
    tracing.take()


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def by_name(records, kind=tracing.Span):
    out = collections.defaultdict(list)
    for r in records:
        if isinstance(r, kind):
            out[r.name].append(r)
    return out


def test_muted_records_nothing_on_its_thread():
    """Inside `muted` no span or counter is recorded (a kernel's plain
    version running a model's spanned composition); around it, as before,
    and nested mutes unwind."""
    tracing.take()
    with profiler():
        with tracing.span("outer"):
            with tracing.muted():
                with tracing.muted():
                    tracing.count("deep")
                with tracing.span("inner"):
                    tracing.count("hidden")
            tracing.count("after")
    recs = tracing.take()
    assert sorted(r.name for r in recs) == ["after", "outer"]
    (after,) = [r for r in recs if r.name == "after"]
    (outer,) = [r for r in recs if r.name == "outer"]
    assert after.parent == outer.id


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not tracing.recording()
    sp = tracing.span("a", rows=3)
    assert sp is tracing.OFF
    with sp as inner:
        inner.set(bucket=8)
        tracing.count("host_reads")
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_nesting_parents_and_one_root_a_request():
    with profiler():
        assert tracing.recording()
        for request in range(2):
            with tracing.span("req", n=request) as sp:
                with tracing.span("child"):
                    with tracing.span("leaf"):
                        tracing.count("host_reads", 2)
                sp.set(done=True)
    recs = tracing.take()
    spans = by_name(recs)
    assert [len(spans[k]) for k in ("req", "child", "leaf")] == [2, 2, 2]
    for req, child, leaf in zip(spans["req"], spans["child"], spans["leaf"]):
        assert req.parent is None and req.root == req.id
        assert child.parent == req.id and leaf.parent == child.id
        assert child.root == leaf.root == req.id
        assert req.start_ns <= child.start_ns <= leaf.start_ns
        assert leaf.end_ns <= child.end_ns <= req.end_ns
        assert req.attrs == {"n": req.attrs["n"], "done": True}
    assert spans["req"][0].root != spans["req"][1].root
    (c1, c2) = by_name(recs, tracing.Count)["host_reads"]
    assert c1.n == 2 and c1.parent == spans["leaf"][0].id
    assert c1.root == spans["req"][0].id and c2.root == spans["req"][1].id
    # records come in the order they end: a leaf before its parents
    assert [r.name for r in recs[:4]] == ["host_reads", "leaf", "child",
                                          "req"]


def test_each_thread_has_its_own_stack():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span("outer", tag=tag):
            barrier.wait()  # both outer spans are open now
            with tracing.span("inner", tag=tag):
                barrier.wait()

    with profiler():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    spans = by_name(tracing.take())
    outer = {s.attrs["tag"]: s for s in spans["outer"]}
    for s in spans["inner"]:
        mine = outer[s.attrs["tag"]]
        assert s.parent == mine.id and s.root == mine.id
        assert s.tid == mine.tid
    assert outer["a"].tid != outer["b"].tid
    assert outer["a"].parent is None and outer["b"].parent is None


def test_counter_events_carry_time_and_amount():
    with profiler():
        t0 = time.time_ns()
        tracing.count("host_reads")
        tracing.count("host_reads", 5)
        t1 = time.time_ns()
    counts = by_name(tracing.take(), tracing.Count)["host_reads"]
    assert [c.n for c in counts] == [1, 5]
    assert all(t0 <= c.t_ns <= t1 and c.parent is None and c.root is None
               for c in counts)


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 5)
    with profiler():
        for i in range(6):
            with tracing.span("s", i=i):
                pass
        tracing.count("host_reads")
        tracing.count("host_reads")
    assert tracing.dropped() == 3
    recs = tracing.take()
    assert [r.attrs["i"] for r in recs] == [0, 1, 2, 3, 4]
    assert tracing.dropped() == 0 and tracing.spans() == []


def test_one_clock_with_the_profiler():
    a = torch.randn(32, 32)
    with profiler() as prof:
        for i in range(50):
            with tracing.span("around", i=i):
                with torch.autograd.profiler.record_function("probe"):
                    a @ a
    spans = sorted(by_name(tracing.take())["around"],
                   key=lambda s: s.start_ns)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "probe"), key=lambda e: e.start_ns())
    assert len(spans) == len(events) == 50
    for s, e in zip(spans, events):
        assert s.start_ns <= e.start_ns() + CLOCK_TOL_NS
        assert e.start_ns() + e.duration_ns() <= s.end_ns + CLOCK_TOL_NS


def test_profile_trace_merges_the_spans_and_clears_them(tmp_path):
    logdir = str(tmp_path / "t")
    with logging.profile_trace(logdir):
        with tracing.span("outer", rows=4):
            with torch.autograd.profiler.record_function("probe"):
                torch.ones(4).sum()
            tracing.count("host_reads")
            tracing.count("host_reads", 2)
    assert tracing.spans() == []
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as fh:
        events = json.load(fh)["traceEvents"]
    vpc = [e for e in events if e.get("cat") == "vpc"]
    (outer,) = [e for e in vpc if e["ph"] == "X"]
    assert outer["name"] == "outer" and outer["pid"] == os.getpid()
    assert outer["args"]["rows"] == 4 and outer["args"]["parent"] is None
    assert outer["args"]["root"] == outer["args"]["id"]
    counters = [e for e in vpc if e["ph"] == "C"]
    assert [e["args"]["host_reads"] for e in counters] == [1, 3]
    # on the timeline of the profiler's own events
    (probe,) = [e for e in events if e.get("name") == "probe"]
    assert outer["ts"] <= probe["ts"] + CLOCK_TOL_NS / 1e3
    assert probe["ts"] + probe["dur"] <= (outer["ts"] + outer["dur"]
                                          + CLOCK_TOL_NS / 1e3)


def test_profile_flag_of_an_entry_point_writes_the_spans(tmp_path,
                                                        monkeypatch):
    """`-profile DIR` on the CPU (record 34, one epoch, M=1): the Chrome
    trace holds the trainer's and the evaluator's spans."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    record = json.loads(open(os.path.join(
        REPO, "Data", "imputation_args.json")).readlines()[33])
    record["epoch"]["default"] = 1
    record["M"]["default"] = 1
    (tmp_path / "Data" / "imputation_args.json").write_text(
        json.dumps(record) + "\n")
    monkeypatch.chdir(tmp_path)
    assert imputation.main(["-device", "cpu", "-profile", "prof"]) == 0
    (trace,) = os.listdir("prof")
    with open(os.path.join("prof", trace)) as fh:
        events = json.load(fh)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "vpc" and e["ph"] == "X")
    assert names["train.epoch"] == 1 and names["eval_vae"] == 1
    assert names["eval.split"] == 2 and names["train.step"] >= 1
    assert tracing.spans() == []


# -- the program's layers ----------------------------------------------------


@pytest.fixture(scope="module")
def wine():
    cfg = RunConfig(vae_type="reg_EDDI1", M=2, epoch=1)
    ds = loaders.data_loader(os.path.join(REPO, "Data"), cfg.vae_type, 30,
                             64, "wine", device="cpu")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 ds.obs_dim, device="cpu")
    return cfg, ds, params


def test_eval_vae_spans_and_host_reads(wine):
    cfg, ds, params = wine
    with profiler():
        evaluate.eval_vae(ds, cfg, params=params, save=False, device="cpu")
    recs = tracing.take()
    spans = by_name(recs)
    steps = sum(-(-s.n // min(cfg.batch_size, s.n))
                for s in (ds.train, ds.test))
    (call,) = spans["eval_vae"]
    assert len(spans["eval.split"]) == 2
    for name in ("eval.batch", "eval.draw", "model.eval_step", "eval.stats",
                 "ops.embed_pool"):
        assert len(spans[name]) == cfg.M * steps, name
    assert len(spans["eval.readback"]) == 2
    assert all(s.root == call.id for r in spans.values() for s in r)
    assert {s.attrs["rows"] for s in spans["eval.batch"]} == {
        min(cfg.batch_size, ds.train.n), ds.test.n}
    reads = by_name(recs, tracing.Count)["host_reads"]
    assert sum(c.n for c in reads) == 2
    assert all(c.root == call.id for c in reads)


def test_eval_vae_is_the_same_with_the_profiler_on(wine):
    cfg, ds, params = wine
    off = evaluate.eval_vae(ds, cfg, params=params, save=False, device="cpu")
    with profiler():
        on = evaluate.eval_vae(ds, cfg, params=params, save=False,
                               device="cpu")
    assert on == off  # the same floats, bit for bit


def _impute(cfg, ds, params):
    srv = serve.ImputationServer(params, cfg, ds.obs_dim, device="cpu")
    srv.impute(ds.test.x[:5].numpy(), ds.test.mask[:5].numpy())


def _train(cfg, ds, params):
    train.train(ds, cfg, save=False, device="cpu", params=params)


def _episode(cfg, ds, params):
    active_learning.run_episode(get_model(cfg), params, cfg, ds.test.x,
                                active_learning.default_noise(cfg, "cpu"))


def _eval(cfg, ds, params):
    evaluate.eval_vae(ds, cfg, params=params, save=False, device="cpu")


PATHS = {
    "eval": (_eval, {"eval_vae": 1, "eval.split": 2}, 2),
    "impute": (_impute, {"serve.impute": 1, "serve.draw": 1,
                         "serve.copy_in": 1, "model.eval_step": 1,
                         "serve.copy_out": 1, "ops.embed_pool": 1}, 1),
    "train": (_train, {"train.epoch": 1, "train.step": 3, "train.draw": 3,
                       "model.train_loss": 3, "train.backward": 3,
                       "train.optimizer": 3, "ops.fused_posterior": 3}, 1),
    "al": (_episode, {"al.episode": 1, "al.step": 12, "al.impute": 12,
                      "al.rewards": 12, "al.select": 12,
                      "model.eval_step": 25}, 0),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_each_layer_records_only_under_the_profiler(wine, path):
    """Without a profiler a call leaves no record; under one it leaves its
    layer's spans, one root a request, and its host reads."""
    fn, expected, reads = PATHS[path]
    cfg, ds, params = wine
    fn(cfg, ds, params)
    assert tracing.spans() == []
    with profiler():
        fn(cfg, ds, params)
    recs = tracing.take()
    spans = by_name(recs)
    got = {name: len(spans[name]) for name in expected}
    assert got == expected
    roots = {s.root for r in spans.values() for s in r}
    assert len(roots) == 1
    assert sum(c.n for c in by_name(recs, tracing.Count)["host_reads"]) == (
        reads)
    if path == "impute":
        assert spans["serve.impute"][0].attrs == {"rows": 5, "bucket": 8}


def test_ensemble_evaluation_inherits_the_spans(wine):
    """The vmapped evaluator calls `_batch_stats` and the kernel wrapper
    once a batch for every replica: their spans, once a batch."""
    cfg, ds, params = wine
    ens = checkpoint.unflatten({k: torch.stack([v, v]) for k, v in
                                checkpoint.flatten(params).items()})
    with profiler():
        evaluate.eval_vae_ensemble([ds, ds], [cfg, cfg], ens, save=False,
                                   device="cpu")
    spans = by_name(tracing.take())
    steps = sum(-(-s.n // min(cfg.batch_size, s.n))
                for s in (ds.train, ds.test))
    for name in ("model.eval_step", "eval.stats", "ops.embed_pool"):
        assert len(spans[name]) == cfg.M * steps, name


# -- the importance-weighted model's own spans --------------------------------

MIWAE_SPANS = ("miwae.encode", "miwae.decode", "miwae.likelihood",
               "miwae.weights")


class _NoTracing:
    """`utils/tracing` with every site removed: what a program without the
    model's spans computes."""

    @staticmethod
    def span(name, **attrs):
        return contextlib.nullcontext()

    @staticmethod
    def count(name, n=1):
        pass


@pytest.mark.parametrize("path", ["fused", "eager"])
@pytest.mark.parametrize("vae_type,branches", [("vanilla_MIWAE1", 1),
                                               ("reg_MIWAE1", 2)])
def test_miwae_spans_nest_in_the_model_step(vae_type, branches, path,
                                            monkeypatch):
    """A profiled `eval_vae` of a MIWAE type records the model's spans
    inside each `model.eval_step` and `iw_samples` = rows x K decoded (both
    branches of a regularized type): on IW1's path (`_fused`, which
    `eval_vae` takes) the one call under `miwae.decode` and `iw_fused_rows`
    = the stream's rows; on the eager path all four spans. Unprofiled it
    records nothing, and the results are bit-equal to those of the model
    without its spans."""
    if path == "eager":
        monkeypatch.setattr(miwae, "_fused", lambda: False)
    cfg = RunConfig(vae_type=vae_type, valid_k=16, M=1)
    ds = loaders.data_loader(os.path.join(REPO, "Data"), cfg.vae_type, 50,
                             64, "wine", device="cpu")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 ds.obs_dim, device="cpu")
    off = evaluate.eval_vae(ds, cfg, params=params, save=False, device="cpu")
    assert tracing.spans() == []
    with profiler():
        on = evaluate.eval_vae(ds, cfg, params=params, save=False,
                               device="cpu")
    recs = tracing.take()
    spans = by_name(recs)
    steps = [min(cfg.batch_size, s.n) for s in (ds.train, ds.test)
             for _ in range(-(-s.n // min(cfg.batch_size, s.n)))]
    model = {s.id for s in spans["model.eval_step"]}
    assert len(model) == len(steps)
    recorded = MIWAE_SPANS if path == "eager" else ("miwae.decode",)
    for name in MIWAE_SPANS:
        if name not in recorded:
            assert name not in spans, name
            continue
        assert len(spans[name]) == len(steps), name
        assert {s.parent for s in spans[name]} == model, name
    counts = by_name(recs, tracing.Count)
    samples = counts["iw_samples"]
    assert {c.parent for c in samples} == model
    assert sum(c.n for c in samples) == branches * sum(steps) * cfg.valid_k
    if path == "fused":
        assert sum(c.n for c in counts["iw_fused_rows"]) == (
            branches * sum(steps))
    else:
        assert "iw_fused_rows" not in counts
    monkeypatch.setattr(miwae, "tracing", _NoTracing)
    plain = evaluate.eval_vae(ds, cfg, params=params, save=False,
                              device="cpu")
    assert off == on == plain  # the same floats, bit for bit


# -- the MNAR evaluator and the notMIWAE model's spans ------------------------

NOTMIWAE_SPANS = ("notmiwae.encode", "notmiwae.decode", "notmiwae.likelihood",
                  "notmiwae.missingness", "notmiwae.weights")


def _mnar(M, valid_k=16):
    cfg = RunConfig(vae_type="reg_notMIWAE1", valid_k=valid_k, M=M)
    ds = loaders.data_loader_mnar(os.path.join(REPO, "Data"), cfg.vae_type,
                                  50, 64, "wine", device="cpu")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 ds.obs_dim, device="cpu")
    return cfg, ds.train, params


def _check_mnar_spans(M, path, monkeypatch):
    """A profiled `eval_vae_mnar` call records its root `eval_vae_mnar`;
    in it, a rep's `eval.draw` and `model.eval_step`, the model's spans
    inside each `model.eval_step` (on IW2's path, `_fused`, which the
    evaluator takes, the one call under `notmiwae.decode`; on the eager
    path all five), and `eval.readback` around the call's one
    `host_reads`; `iw_samples` = rows x K a rep, and on IW2's path
    `iw_fused_samples` the same. Unprofiled it records nothing, and the
    RMSE is bit-equal to that of the model without its spans."""
    if path == "eager":
        monkeypatch.setattr(notmiwae, "_fused", lambda: False)
    cfg, split, params = _mnar(M)
    call = lambda: evaluate.eval_vae_mnar(  # noqa: E731
        split.x, split.mask, cfg, params=params, save=False, device="cpu")
    off = call()
    assert tracing.spans() == []
    with profiler():
        on = call()
    recs = tracing.take()
    spans = by_name(recs)
    (root,) = spans["eval_vae_mnar"]
    assert root.parent is None
    steps = {s.id for s in spans["model.eval_step"]}
    assert len(steps) == len(spans["eval.draw"]) == M
    assert {s.parent for s in spans["model.eval_step"] + spans["eval.draw"]
            } == {root.id}
    recorded = NOTMIWAE_SPANS if path == "eager" else ("notmiwae.decode",)
    for name in NOTMIWAE_SPANS:
        if name not in recorded:
            assert name not in spans, name
            continue
        assert len(spans[name]) == M, name
        assert {s.parent for s in spans[name]} == steps, name
    (read,) = spans["eval.readback"]
    assert read.parent == root.id
    assert all(s.root == root.id for r in spans.values() for s in r)
    counts = by_name(recs, tracing.Count)
    (reads,) = counts["host_reads"]
    assert reads.n == 1 and reads.parent == read.id
    samples = counts["iw_samples"]
    assert {c.parent for c in samples} == steps
    assert sum(c.n for c in samples) == M * split.n * cfg.valid_k
    fused = counts.get("iw_fused_samples", [])
    assert sum(c.n for c in fused) == (
        0 if path == "eager" else M * split.n * cfg.valid_k)
    monkeypatch.setattr(notmiwae, "tracing", _NoTracing)
    assert off == on == call()  # the same float, bit for bit


@pytest.mark.parametrize("M", [1, 2])
def test_eval_vae_mnar_spans_nest_and_read_once(M, monkeypatch):
    _check_mnar_spans(M, "fused", monkeypatch)


@pytest.mark.parametrize("M", [1, 2])
def test_eval_vae_mnar_spans_on_the_eager_path(M, monkeypatch):
    _check_mnar_spans(M, "eager", monkeypatch)


def test_mnar_ensemble_evaluation_has_the_root_span():
    cfg, split, params = _mnar(1)
    ens = checkpoint.unflatten({k: torch.stack([v, v]) for k, v in
                                checkpoint.flatten(params).items()})
    with profiler():
        evaluate.eval_vae_mnar_ensemble(split.x, split.mask, cfg, ens,
                                        save=False, device="cpu")
    recs = tracing.take()
    spans = by_name(recs)
    (root,) = spans["eval_vae_mnar"]
    assert {s.root for r in spans.values() for s in r} == {root.id}
    assert len(spans["notmiwae.decode"]) == 1
    assert sum(c.n for c in by_name(recs, tracing.Count)["host_reads"]) == 1


def test_profile_flag_of_the_mnar_entry_point_writes_the_spans(tmp_path,
                                                               monkeypatch):
    """`-profile DIR` on the CPU (the MNAR grid's record 2, reg_notMIWAE1,
    one epoch, valid_k cut to 20): the Chrome trace holds the MNAR
    evaluator's and the model's spans and both counters."""
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    record = json.loads(open(os.path.join(
        REPO, "Data", "imputation_args_mnar.json")).readlines()[1])
    assert record["vae_type"]["default"] == "reg_notMIWAE1"
    (tmp_path / "Data" / "imputation_args_mnar.json").write_text(
        json.dumps(record) + "\n")
    monkeypatch.chdir(tmp_path)
    assert imputation_mnar.main(["-device", "cpu", "-valid_k", "20",
                                 "-profile", "prof"]) == 0
    (trace,) = os.listdir("prof")
    with open(os.path.join("prof", trace)) as fh:
        events = json.load(fh)["traceEvents"]
    vpc = [e for e in events if e.get("cat") == "vpc"]
    names = collections.Counter(e["name"] for e in vpc if e["ph"] == "X")
    assert names["eval_vae_mnar"] == 1 and names["eval.readback"] == 1
    for name in NOTMIWAE_SPANS:
        # the training steps' model spans, and the evaluation's once
        assert names[name] >= 2, name
    counters = {e["name"] for e in vpc if e["ph"] == "C"}
    assert {"host_reads", "iw_samples"} <= counters
    assert tracing.spans() == []
