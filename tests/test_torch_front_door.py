"""The slice as a whole against the reference: the same mixed traffic
through the reference's `FrontDoor` (JAX) and the port's
(`repro_torch.launch.serve.FrontDoor`, ``device="cpu"``), on the CPU.

Engines: the SMOKE rwkv6 LM (chunked prefill; in one case the SMOKE
llama3.2-1b LM, the dense family's masked decode scan, without the
session lane, which a KV-cache family cannot serve), `_make_vision_engine`'s
vision model (40², width 0.25, head 64) as a two-replica `ReplicaPool`,
a delta-gated `StreamEngine` and a `SessionEngine`, the reference's
weights carried across by `repro_torch.compat`.  The two doors must give
the same ``(name, uid)`` completion list and door tick, the same value
for every ``*_ticks`` key of ``latency_summary()`` at any depth, LM and
session tokens exactly, vision probabilities and stream boxes and scores
within 1e-5 (fp32 through the network, sums in another order), and
tick-domain trace exports equal byte for byte.  Held at LM tick cost 1
and 4, and under a `FaultPlan` on every engine, where the faulted,
failed and evicted uids must match too.  The reference's degradation
ladder is turned off (``degrade_after`` out of reach): the port has
none.  The launcher's ``--mixed`` branch prints the reference's summary
lines.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import serve as j_serve
from repro.models.families import get_family as j_get_family
from repro.models.mobilenetv2 import MNV2Config as JMNV2Config
from repro.models.mobilenetv2 import init_mnv2 as j_init_mnv2
from repro.obs import Tracer as JTracer
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import ReplicaPool as JReplicaPool
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SessionEngine as JSessionEngine
from repro.serving import SessionRequest as JSessionRequest
from repro.serving import VisionEngine as JVisionEngine
from repro.serving import VisionRequest as JVisionRequest
from repro.video import DetectConfig as JDetectConfig
from repro.video import StreamEngine as JStreamEngine
from repro.video import StreamRequest as JStreamRequest
from repro.video import init_detect_head as j_init_detect_head
from repro_torch import compat
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticVWW
from repro_torch.launch import serve
from repro_torch.launch.serve import FrontDoor
from repro_torch.models.mobilenetv2 import MNV2Config
from repro_torch.obs import Tracer, validate_trace_events
from repro_torch.serving import (
    FaultInjector,
    FaultPlan,
    ReplicaPool,
    Request,
    ServeEngine,
    SessionEngine,
    SessionRequest,
    VisionEngine,
    VisionRequest,
)
from repro_torch.video import (
    DetectConfig,
    StreamEngine,
    StreamRequest,
    SyntheticVideo,
)

SIZE = 40
VKW = dict(variant="p2m", image_size=SIZE, width=0.25, head_channels=64)
TOL = 1e-5
NEVER = 10 ** 9  # the reference's degrade_after: its ladder never fires


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(reference trees, port trees): the LM, the vision model and the
    detection head."""
    jcfg = j_get_smoke_config("rwkv6-3b").replace(dtype=jnp.float32,
                                                  wkv_impl="xla")
    jlm, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jvp, jvb = j_init_mnv2(jax.random.PRNGKey(1), JMNV2Config(**VKW))
    jdet = j_init_detect_head(jax.random.PRNGKey(2), 64, JDetectConfig())
    jdense_cfg = j_get_smoke_config("llama3.2-1b").replace(dtype=jnp.float32)
    jdense, _ = j_get_family(jdense_cfg).init(jax.random.PRNGKey(0),
                                              jdense_cfg)
    ref = (jlm, jvp, jvb, jdet, jdense)
    port = tuple(compat.tree_from_reference(jax.tree.map(np.asarray, t),
                                            device="cpu") for t in ref)
    return {"rwkv6-3b": jcfg, "llama3.2-1b": jdense_cfg}, ref, port


def _traffic():
    """Seeded mixed traffic on the door's clock: (kind, uid, payload,
    arrival tick)."""
    rng = np.random.default_rng(7)
    out = []
    for uid in range(6):
        prompt = rng.integers(0, 512, int(rng.integers(3, 20))).tolist()
        out.append(("lm", uid, prompt, int(rng.integers(0, 4))))
    imgs = SyntheticVWW(image_size=SIZE, batch=9, seed=1).batch_at(0)[
        "images"]
    out += [("vision", 1000 + i, imgs[i], i // 2) for i in range(9)]
    out += [("stream", 2000 + i,
             SyntheticVideo(image_size=SIZE, n_frames=n, hold=2,
                            seed=i).frames(), i)
            for i, n in enumerate((6, 4, 5))]
    out += [("chat", 3000 + i,
             [rng.integers(0, 512, int(rng.integers(2, 9))).tolist()
              for _ in range(2 + i)], i) for i in range(2)]
    return out


def _run(side, models, lm_cost, plan, arch="rwkv6-3b"):
    """Build the door on one side ("ref" or "port"), replay the traffic,
    and return the door, its tracer and its injectors.  A dense LM
    (``arch`` llama3.2-1b) has no session engine: the chat lane and its
    traffic stay out."""
    jcfgs, ref, port = models
    is_ref = side == "ref"
    dense = arch != "rwkv6-3b"
    if is_ref:
        lm_p, vp, vb, det, dense_p = ref
        cfg, vcfg = jcfgs[arch], JMNV2Config(**VKW)
        Serve, Session, Vision, Stream, Pool = (
            JServeEngine, JSessionEngine, JVisionEngine, JStreamEngine,
            JReplicaPool)
        Req, SReq, VReq, StReq = (JRequest, JSessionRequest, JVisionRequest,
                                  JStreamRequest)
        Door, Tr, Inj, Plan = j_serve.FrontDoor, JTracer, JFaultInjector, \
            JFaultPlan
        dcfg = JDetectConfig()
        vkw = dict(degrade_after=NEVER)
    else:
        lm_p, vp, vb, det, dense_p = port
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        vcfg = MNV2Config(**VKW)
        Serve, Session, Vision, Stream, Pool = (
            ServeEngine, SessionEngine, VisionEngine, StreamEngine,
            ReplicaPool)
        Req, SReq, VReq, StReq = (Request, SessionRequest, VisionRequest,
                                  StreamRequest)
        Door, Tr, Inj, Plan = FrontDoor, Tracer, FaultInjector, FaultPlan
        dcfg = DetectConfig()
        vkw = dict(device="cpu")
    injectors = {}

    def core(name, **kw):
        if plan is None:
            return kw
        injectors[name] = Inj(Plan(**plan[name]))
        return {**kw, "faults": injectors[name], "launch_retries": 1}

    lm_kw = {} if is_ref else {"device": "cpu"}
    if dense:
        lm_p = dense_p
    engines = {
        "lm": Serve(lm_p, cfg, max_batch=2, max_len=64, prefill_chunk=4,
                    tick_cost=lm_cost,
                    **core("lm", max_serve_ticks=40), **lm_kw),
        "vision": Pool(*[Vision(vp, vb, vcfg, max_batch=4,
                                **core(f"vision[{k}]", max_serve_ticks=4),
                                **vkw) for k in range(2)]),
        "stream": Stream(vp, vb, vcfg, det, det_cfg=dcfg, max_streams=2,
                         **core("stream", max_serve_ticks=12), **vkw),
    }
    if not dense:
        engines["chat"] = Session(lm_p, cfg, max_batch=1, max_len=128,
                                  prefill_chunk=4,
                                  **core("chat", max_serve_ticks=60),
                                  **lm_kw)
    tracer = Tr()
    door = Door(tracer=tracer, **engines)
    kinds = {"lm": lambda u, p, t: Req(uid=u, prompt=list(p),
                                       max_new_tokens=4, arrival_tick=t),
             "vision": lambda u, p, t: VReq(uid=u, image=p, arrival_tick=t),
             "stream": lambda u, p, t: StReq(uid=u, frames=p,
                                             arrival_tick=t),
             "chat": lambda u, p, t: SReq(uid=u, turns=[list(x) for x in p],
                                          max_new_tokens=3, arrival_tick=t)}
    door.run([kinds[k](u, p, t) for k, u, p, t in _traffic()
              if k in engines], on_undrained="raise")
    return door, tracer, injectors


def _ticks(summary, path=""):
    """Every ``*_ticks`` value of a latency summary, keyed by its path."""
    out = {}
    if isinstance(summary, dict):
        for k, v in summary.items():
            if k.endswith("_ticks") and isinstance(v, (int, float)):
                out[path + k] = v
            else:
                out.update(_ticks(v, f"{path}{k}."))
    elif isinstance(summary, list):
        for i, v in enumerate(summary):
            out.update(_ticks(v, f"{path}{i}."))
    return out


def _ledgers(door):
    def reqs(e, kind):
        return sorted((r.uid, getattr(r, "failure", None))
                      for r in getattr(e, kind))
    return {name: {kind: reqs(e, kind) for kind in
                   ("failed", "evicted", "rejected")}
            for name, e in door.engines.items()}


PLAN = {  # one plan an engine: every kind, rates and explicit targets
    "lm": dict(launch_error_rate=0.1, nan_rate=0.03, stuck_uids=(4,),
               seed=1),
    "vision[0]": dict(launch_error_ticks=(1,), nan_rate=0.2, seed=2),
    "vision[1]": dict(nan_ticks=(2,), stuck_uids=(1007,), seed=3),
    "stream": dict(launch_error_rate=0.1, nan_ticks=(3,),
                   stuck_uids=(2002,), seed=4),
    "chat": dict(slow_rate=0.2, launch_error_ticks=(5,), seed=5),
}


@pytest.mark.parametrize("lm_cost,plan,arch", [
    (1, None, "rwkv6-3b"), (4, None, "rwkv6-3b"), (4, PLAN, "rwkv6-3b"),
    (1, None, "llama3.2-1b")],
    ids=["cost1", "cost4", "cost4-faults", "llama-cost1"])
def test_door_matches_the_reference_door(models, lm_cost, plan, arch):
    ref, jtr, jinj = _run("ref", models, lm_cost, plan, arch)
    door, tr, inj = _run("port", models, lm_cost, plan, arch)

    assert [(n, r.uid) for n, r in door.completed] == \
        [(n, r.uid) for n, r in ref.completed]
    assert door.tick == ref.tick
    assert door.down == ref.down == {}
    assert _ticks(door.latency_summary()) == _ticks(ref.latency_summary())
    assert _ledgers(door) == _ledgers(ref)
    if plan is not None:
        assert {k: (i.counts, sorted(i.poisoned_uids))
                for k, i in inj.items()} == \
            {k: (i.counts, sorted(i.poisoned_uids)) for k, i in jinj.items()}
        assert sum(sum(i.counts.values()) for i in inj.values()) > 0
        assert any(_ledgers(door)[n]["failed"] for n in door.engines)

    ref_by = {(n, r.uid): r for n, r in ref.completed}
    for name, r in door.completed:
        j = ref_by[(name, r.uid)]
        if name == "lm":
            assert r.output == j.output
        elif name == "chat":
            assert r.outputs == j.outputs
        elif name == "vision":
            np.testing.assert_allclose(r.probs, np.asarray(j.probs),
                                       rtol=TOL, atol=TOL)
        else:
            assert r.skip_count == j.skip_count
            assert len(r.frame_outputs) == len(j.frame_outputs)
            for (b, s), (jb, js) in zip(r.frame_outputs, j.frame_outputs):
                np.testing.assert_allclose(b, np.asarray(jb), rtol=TOL,
                                           atol=TOL)
                np.testing.assert_allclose(s, np.asarray(js), rtol=TOL,
                                           atol=TOL)

    text = tr.export()
    assert text == jtr.export()
    assert validate_trace_events(tr.trace_events()) == []
    health = door.health()
    assert all(h["degraded"] is None for h in health["engines"].values())


def _summary_lines(text):
    """The launcher's summary without its wall times."""
    text = re.sub(r" in [0-9.]+s", "", text)
    text = re.sub(r" on cpu", "", text)
    return [re.sub(r" mean_launch=[0-9.]+ ms", "", line)
            for line in text.strip().splitlines()]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "llama3.2-1b"])
def test_launcher_mixed_prints_the_references_summary(capsys, monkeypatch,
                                                      arch):
    argv = ["--arch", arch, "--smoke", "--mixed", "--video-streams",
            "2", "--vision-replicas", "2", "--vision-requests", "6",
            "--requests", "4", "--max-new-tokens", "6", "--prefill-chunk",
            "4", "--lm-tick-cost", "2"]
    serve.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    ref = capsys.readouterr().out
    assert port.startswith("front door: 4 LM requests (24 tokens) + 6 "
                           "frames + 2 video streams")
    assert "on cpu" in port
    assert _summary_lines(port) == _summary_lines(ref)
