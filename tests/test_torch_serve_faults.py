"""The port's serving-tier robustness against the JAX package's: admission
deadlines, transient slot/page faults with retry-and-re-prefill, and the
restart policy layer.

* ``TransientFaults.failed_slots`` equals the reference's draw for draw
  (NumPy in both packages), over 200 steps of random active sets;
* ``RestartPolicy``, ``Supervisor``, ``HeartbeatMonitor`` and
  ``StragglerDetector`` give the reference's sequences;
* with the chip phase's pool (8 slots, 16-row pages, 96 pages, max_seq 544)
  and ``eos_id=None``, ``Engine.serve``'s virtual clock on
  ``chip-burst-24-patient`` (and its first burst), with and without
  faults, equals the reference's stamp for stamp, and the numbers
  ``chip_smoke.py`` holds the card to;
* greedy tokens through ``Engine.serve`` with faults equal the reference's
  at float32 (the same weights, ``model_params_to_port``), paged and
  contiguous, for the dense family and for xlstm (contiguous);
* the port's own contract at bfloat16: a faulted run's tokens equal the
  fault-free run's, sampled faulted runs replay the oracle's key chain,
  deterministic faults and exhausted budgets halt with the reference's
  message, deadline rejections carry the reference's timestamps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.faults import TransientFaults as JaxTransientFaults
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.runtime import fault_tolerance as jft
from repro.serve import AdmissionQueue as JaxAdmissionQueue
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import TrafficProfile as JaxTrafficProfile
from repro.serve import generate_arrivals as jax_generate_arrivals
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.faults import TransientFaults
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime.fault_tolerance import RestartPolicy
from repro_torch.serve import AdmissionQueue, Arrival, Engine, Request, TrafficProfile, \
    generate_arrivals, simulate
from repro_torch.serve.traffic import LengthMix

# a generous budget, so that recovery, not halting, is under test
# (tests/test_serve_faults.py:56)
PATIENT = dict(max_restarts=10_000, backoff_s=1.0, backoff_mult=1.0)
# chip_smoke.py's serve-faults phase: its profile, pool and faults
CHIP_PATIENT = dict(
    name="chip-burst-24-patient", num_requests=24, arrival="burst", burst_size=8, num_users=8,
    requests_per_user_tick=0.05, prompt_lens={"choices": [128, 256, 512], "weights": [1, 2, 1]},
    output_lens={"choices": [8, 16, 32], "weights": [1, 2, 1]}, temperature=0.0, seed=0)
CHIP_POOL = dict(batch=8, page_size=16, pool_pages=96)
CHIP_FAULTS = dict(slot_rate=0.05, page_rate=0.002, seed=0)
# the JAX package's numbers on that profile (chip_smoke.py holds the card to them)
CHIP_CLOCK = {(24, False): dict(n_accepted=24, decode_steps=98, makespan_ticks=98.0,
                                faults_injected=0),
              (24, True): dict(n_accepted=24, decode_steps=111, makespan_ticks=150.0,
                               faults_injected=39, retries=39, reprefills=39),
              (8, False): dict(n_accepted=8, makespan_ticks=46.0, faults_injected=0),
              (8, True): dict(n_accepted=8, decode_steps=47, makespan_ticks=58.0,
                              faults_injected=11, retries=11, reprefills=11)}
# the clock tests' model: the reduced smollm cut to one narrow layer
CLOCK_MODEL = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, d_ff=64)
STAT_KEYS = ("decode_steps", "generated_tokens", "prefills", "occupancy", "admission_order",
             "faults_injected", "retries", "reprefills", "n_requests", "n_accepted",
             "n_rejected", "makespan_ticks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's default of a thread per core in
    each of them oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_requests(vocab, *, n=6, temperature=0.0, max_new=8, deadline=None, seed=0, cls=Request):
    """tests/test_serve_faults.py:44-54's requests."""
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, vocab, size=4 + (i % 4)).astype(np.int32),
                max_new_tokens=max_new, temperature=temperature, deadline=deadline)
            for i in range(n)]


@pytest.fixture(scope="module")
def served():
    """Reduced smollm-135m in the port, bfloat16 (the default CallConfig)."""
    cfg = get_config("smollm-135m").reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


def _pair(arch):
    """The reduced model in both packages at float32, the same weights."""
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(jax_get_config(arch).reduced(), JaxCallConfig(remat="none", **f32))
    params = jm.init(jax.random.PRNGKey(0))
    tm = model_params_to_port(get_config(arch).reduced(), jax.tree.map(np.asarray, params),
                              cc=CallConfig(compute_dtype=torch.float32,
                                            cache_dtype=torch.float32), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair("smollm-135m")


def _clock(reqs):
    return [(r.arrival_time, r.admitted_time, r.finish_time, r.pages_peak, r.rejected)
            for r in reqs]


# -------------------- the fault model and the policy layer --------------------
def test_failed_slots_equal_the_reference_over_200_steps():
    rng = np.random.RandomState(0)
    cases = [dict(slot_rate=0.05, page_rate=0.002, seed=0), dict(slot_rate=0.3, seed=5),
             dict(page_rate=0.05, seed=2), dict(slot_rate=0.1, poison=((3, 4), (7, 1)), seed=9)]
    for kw in cases:
        mine, ref = TransientFaults(**kw), JaxTransientFaults(**kw)
        assert mine.is_empty == ref.is_empty is False
        for step in range(200):
            slots = sorted(rng.choice(8, size=rng.randint(0, 9), replace=False).tolist())
            active = [(b, int(rng.randint(10)), int(rng.randint(1, 6))) for b in slots]
            held = [int(rng.randint(0, 35)) for _ in active]
            for pages in (held, None):
                got = mine.failed_slots(step, active, pages)
                assert got == ref.failed_slots(step, active, pages)
                assert set(got) <= set(slots)
    assert TransientFaults().is_empty and TransientFaults(poison=[(1, 2)]).poison == ((1, 2),)
    for bad in (dict(slot_rate=1.0), dict(page_rate=-0.1)):
        with pytest.raises(ValueError) as got:
            TransientFaults(**bad)
        with pytest.raises(ValueError) as want:
            JaxTransientFaults(**bad)
        assert str(got.value) == str(want.value)


def test_restart_policy_sequences_equal_the_reference():
    for kw in (dict(), dict(max_restarts=2), PATIENT, dict(backoff_s=0.5, backoff_mult=3.0)):
        mine, ref = tft.RestartPolicy(**kw), jft.RestartPolicy(**kw)
        for step in (1, 2, 2, 5, 5, 5, 6, 7, 7, 8, 9, 10):
            assert mine.on_fault(step) == ref.on_fault(step)
            assert mine.backoff() == ref.backoff()


def test_supervisor_and_monitors_equal_the_reference():
    def run(ft):
        saved, log = {}, []

        def train_fn(state, batch):
            if batch in (3, 7) and (batch, state) not in log:
                log.append((batch, state))
                raise RuntimeError("injected")
            return state + batch, {}

        sup = ft.Supervisor(save_fn=lambda step, st: saved.__setitem__(step, st),
                            restore_fn=lambda: (saved.get(max(saved), 0), max(saved)) if saved
                            else (0, 0), ckpt_every=2)
        state, step = sup.run(train_fn, 0, lambda s: s, start_step=0, num_steps=10)
        halt = ft.Supervisor(save_fn=lambda *a: None, restore_fn=lambda: (0, 0))

        def always(state, batch):
            raise ValueError("deterministic")

        with pytest.raises(RuntimeError) as err:
            halt.run(always, 0, lambda s: s, start_step=0, num_steps=3)
        hb = ft.HeartbeatMonitor(num_hosts=3, timeout_s=5.0)
        hb.beat(0, now=0.0)
        hb.beat(2, now=4.0)
        sd = ft.StragglerDetector(window=4, min_samples=2)
        for h in range(4):
            for t in range(6):
                sd.record(h, 1.0 + (30.0 if h == 3 else 0.01 * t))
        return (state, step, sup.log, halt.log, str(err.value), hb.dead_hosts(now=6.0),
                hb.healthy(now=3.0), sd.stragglers())

    assert run(tft) == run(jft)
    with pytest.raises(ValueError, match="window"):
        tft.StragglerDetector(window=0)


# -------------------- the virtual clock on the chip's profile --------------------
@pytest.fixture(scope="module")
def chip_models():
    """A one-layer, 32-wide smollm in both packages (bfloat16): with
    eos_id=None the schedule does not depend on the model's numbers, only
    on the profile (vocabulary included), the pool and the fault draws."""
    cfg, jcfg = (dataclasses.replace(get("smollm-135m").reduced(), **CLOCK_MODEL)
                 for get in (get_config, jax_get_config))
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none"))
    return cfg, (jm, jm.init(jax.random.PRNGKey(0))), build_model(cfg, device="cpu", seed=0)


@pytest.mark.parametrize("n,faulted", [(24, False), (24, True), (8, False), (8, True)])
def test_chip_profile_clock_equals_the_reference(chip_models, n, faulted):
    """chip_smoke.py's serve-faults runs on a small model: every stamp,
    page peak and counter equal to the reference's, and its numbers."""
    cfg, (jm, params), tm = chip_models
    prof = dict(CHIP_PATIENT, num_requests=n)
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            p = JaxTrafficProfile.from_dict(prof)
            eng = JaxEngine(jm, params, max_seq=p.max_rows, **CHIP_POOL)
            arrivals = jax_generate_arrivals(p, cfg.vocab_size)
            queue = JaxAdmissionQueue(arrivals, max_seq=eng.max_seq)
            kw = dict(faults=JaxTransientFaults(**CHIP_FAULTS),
                      restart_policy=jft.RestartPolicy(**PATIENT)) if faulted else {}
        else:
            p = TrafficProfile.from_dict(prof)
            eng = Engine(tm, max_seq=p.max_rows, **CHIP_POOL)
            arrivals = generate_arrivals(p, cfg.vocab_size)
            queue = AdmissionQueue(arrivals, max_seq=eng.max_seq)
            kw = dict(faults=TransientFaults(**CHIP_FAULTS),
                      restart_policy=RestartPolicy(**PATIENT)) if faulted else {}
        done = eng.serve(queue, seed=0, do_sample=False, **kw)
        index = {id(a.request): i for i, a in enumerate(arrivals)}
        out.append(({k: eng.last_stats[k] for k in STAT_KEYS},
                    _clock(a.request for a in arrivals), [index[id(r)] for r in done]))
        assert eng.slots.allocator.n_held == 0
    assert out[0] == out[1]
    stats = out[1][0]
    for key, want in CHIP_CLOCK[(n, faulted)].items():
        assert stats[key] == want, key
    if faulted:
        assert stats["makespan_ticks"] > CHIP_CLOCK[(n, False)]["makespan_ticks"]


# -------------------- greedy tokens against the reference --------------------
@pytest.mark.parametrize("arch,page_size", [("smollm-135m", None), ("smollm-135m", 8),
                                            ("smollm-135m", 5), ("xlstm-350m", None)])
def test_faulted_serve_tokens_equal_the_reference_at_float32(pair, arch, page_size):
    """The same faulted traffic through both engines at float32: the same
    tokens for every request, the same counters and the same clock."""
    jm, params, tm = pair if arch == "smollm-135m" else _pair(arch)
    vocab = jm.cfg.vocab_size
    faults = dict(slot_rate=0.15, page_rate=0.05 if page_size else 0.0, seed=0)
    geo = dict(batch=2, max_seq=32, page_size=page_size)
    jeng, teng = JaxEngine(jm, params, **geo), Engine(tm, **geo)
    jreqs = make_requests(vocab, cls=JaxRequest)
    treqs = make_requests(vocab)
    jeng.serve(JaxAdmissionQueue.from_requests(jreqs, max_seq=32), seed=0, do_sample=False,
               faults=JaxTransientFaults(**faults), restart_policy=jft.RestartPolicy(**PATIENT),
               backoff_cap=4.0)
    teng.serve(AdmissionQueue.from_requests(treqs, max_seq=32), seed=0, do_sample=False,
               faults=TransientFaults(**faults), restart_policy=RestartPolicy(**PATIENT),
               backoff_cap=4.0)
    assert teng.last_stats["faults_injected"] > 0
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert {k: teng.last_stats[k] for k in STAT_KEYS} == {k: jeng.last_stats[k]
                                                          for k in STAT_KEYS}
    assert _clock(treqs) == _clock(jreqs)


def test_deadline_rejections_are_timestamped_as_the_reference(pair):
    """batch=1 and simultaneous arrivals under a 3-tick deadline: the same
    request served, the same rejections with the same stamps and reasons."""
    jm, params, tm = pair
    jeng, teng = JaxEngine(jm, params, batch=1, max_seq=32), Engine(tm, batch=1, max_seq=32)
    jq = JaxAdmissionQueue.from_requests(
        make_requests(jm.cfg.vocab_size, n=4, deadline=3.0, cls=JaxRequest), max_seq=32)
    tq = AdmissionQueue.from_requests(make_requests(jm.cfg.vocab_size, n=4, deadline=3.0),
                                      max_seq=32)
    jdone = jeng.serve(jq, seed=0, do_sample=False)
    tdone = teng.serve(tq, seed=0, do_sample=False)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert len(tq.rejected) == 3
    assert [(rj.index, rj.time, rj.reason) for rj in tq.rejected] == \
        [(rj.index, rj.time, rj.reason) for rj in jq.rejected]
    for rj in tq.rejected:
        assert rj.reason.startswith("deadline exceeded") and rj.time > 3.0
        assert rj.request.rejected == rj.reason
    assert teng.last_stats["n_rejected"] == 3


# -------------------- the port's own contract --------------------
def test_empty_faults_is_no_injection(served):
    cfg, model = served
    eng = Engine(model, batch=2, max_seq=32)
    base = eng.serve(AdmissionQueue.from_requests(make_requests(cfg.vocab_size, n=4, max_new=6),
                                                  max_seq=32), seed=0, do_sample=False)
    base_stats = dict(eng.last_stats)
    got = eng.serve(AdmissionQueue.from_requests(make_requests(cfg.vocab_size, n=4, max_new=6),
                                                 max_seq=32), seed=0, do_sample=False,
                    faults=TransientFaults())
    assert [g.out_tokens for g in got] == [b.out_tokens for b in base]
    assert eng.last_stats == base_stats
    assert eng.last_stats["faults_injected"] == eng.last_stats["retries"] == 0


@pytest.mark.parametrize("page_size", [None, 8])
def test_transient_faults_token_identical_recovery(served, page_size):
    """A 15 % slot fault rate (and page faults when paged), patient budget:
    every request, faulted or not, finishes with the fault-free run's
    tokens at a strictly larger makespan; a paged wave returns its pages."""
    cfg, model = served
    eng = Engine(model, batch=2, max_seq=32, page_size=page_size)
    mk = lambda: make_requests(cfg.vocab_size, n=6, max_new=8)  # noqa: E731
    clean = eng.serve(AdmissionQueue.from_requests(mk(), max_seq=32), seed=0, do_sample=False)
    clean_span = eng.last_stats["makespan_ticks"]
    faulty = eng.serve(AdmissionQueue.from_requests(mk(), max_seq=32), seed=0, do_sample=False,
                       faults=TransientFaults(slot_rate=0.15, page_rate=0.05 if page_size else 0,
                                              seed=0),
                       restart_policy=RestartPolicy(**PATIENT), backoff_cap=4.0)
    st = eng.last_stats
    assert st["faults_injected"] > 0
    assert st["retries"] == st["faults_injected"] == st["reprefills"]
    assert st["makespan_ticks"] > clean_span and len(faulty) == len(clean)
    by_prompt = {tuple(r.prompt.tolist()): r for r in clean}
    for g in faulty:
        assert g.done and g.out_tokens == by_prompt[tuple(g.prompt.tolist())].out_tokens
    if page_size:
        alloc = eng.slots.allocator
        assert alloc.n_held == 0 and alloc.n_free == alloc.n_pages
        assert all(0 < g.pages_peak <= 4 for g in faulty)


def test_sampled_faulty_run_replays_the_oracle_chain(served):
    """Temperature sampling through a faulty run: the retried step rebuilds
    the key chain, so sampled tokens equal the port's oracle's."""
    cfg, model = served
    eng = Engine(model, batch=2, max_seq=32)
    mk = lambda: make_requests(cfg.vocab_size, n=4, temperature=0.8, max_new=6)  # noqa: E731
    got = eng.serve(AdmissionQueue.from_requests(mk(), max_seq=32), seed=7,
                    faults=TransientFaults(slot_rate=0.2, seed=1),
                    restart_policy=RestartPolicy(**PATIENT))
    assert eng.last_stats["faults_injected"] > 0
    by_prompt = {tuple(r.prompt.tolist()): r for r in eng.generate_sequential(mk(), seed=7)}
    for g in got:
        assert g.out_tokens == by_prompt[tuple(g.prompt.tolist())].out_tokens


@pytest.mark.parametrize("poison,policy,match", [
    (((0, 1),), PATIENT, "halted after repeated faults at request 0, token 1 "
                         r"\(restart budget 10000\)"),
    (((1, 2),), dict(max_restarts=0), "restart budget 0"),
])
def test_poison_and_exhausted_budget_halt_as_the_reference(pair, poison, policy, match):
    jm, params, tm = pair
    errors = []
    for eng, qcls, rcls, fcls, pcls in (
            (JaxEngine(jm, params, batch=2, max_seq=32), JaxAdmissionQueue, JaxRequest,
             JaxTransientFaults, jft.RestartPolicy),
            (Engine(tm, batch=2, max_seq=32), AdmissionQueue, Request, TransientFaults,
             RestartPolicy)):
        queue = qcls.from_requests(make_requests(jm.cfg.vocab_size, n=2, max_new=6, cls=rcls),
                                   max_seq=32)
        with pytest.raises(RuntimeError, match=match) as err:
            eng.serve(queue, seed=0, do_sample=False, faults=fcls(poison=poison),
                      restart_policy=pcls(**policy))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_deadline_counts_from_arrival_not_defer():
    """push_back keeps the original arrival time: a deferred admission does
    not extend the deadline window."""
    queue = AdmissionQueue([Arrival(0.0, r) for r in make_requests(512, n=1, deadline=5.0)])
    queue.poll(0.0)
    queue.push_back(*queue.pop())
    queue.poll(4.0)
    assert len(queue) == 1
    queue.poll(6.0)
    assert len(queue) == 0 and queue.rejected[0].time == 6.0
    assert queue.rejected[0].reason.startswith("deadline exceeded")


def test_traffic_payload_carries_the_rejection_audit(served):
    """tests/test_serve_faults.py:249-273 on the port: schema version 2,
    every rejection with its index, stamp and reason; survivors match the
    oracle."""
    cfg, model = served
    prof = TrafficProfile(name="faults-audit", num_requests=8, arrival="burst", burst_size=8,
                          prompt_lens=LengthMix(choices=[6]), output_lens=LengthMix(choices=[8]),
                          num_users=1, requests_per_user_tick=0.5, seed=0, deadline=4.0)
    payload = simulate(Engine(model, batch=1, max_seq=32), prof)
    assert payload["schema_version"] == 2 and payload["deadline"] == 4.0
    assert 0 < payload["n_deadline_rejected"] == payload["n_rejected"]
    assert payload["n_accepted"] + payload["n_rejected"] == 8
    assert len(payload["rejections"]) == payload["n_rejected"]
    for rj in payload["rejections"]:
        assert set(rj) == {"index", "time", "reason"}
        assert rj["reason"].startswith("deadline exceeded")
        assert 0.0 < rj["time"] <= payload["makespan_ticks"]
    assert payload["matches_sequential"]
    patient = simulate(Engine(model, batch=2, max_seq=32),
                       dataclasses.replace(prof, deadline=None))
    assert patient["deadline"] is None and patient["rejections"] == []
