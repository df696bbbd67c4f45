"""The port's traffic simulator against the JAX package's.

* profile validation: the same messages for every malformed field, the
  same round trip, the committed ``examples/traffic_*.json`` read as they
  are;
* ``generate_arrivals`` equals the reference's (times, prompts, budgets,
  deadlines) on both committed profiles and on ``chip-burst-24``, the
  profile of ``chip_smoke.py``'s serve-traffic phase;
* ``simulate(check=False)`` on ``chip-burst-24`` with the chip's pool (8
  slots, 16-row pages, 96 pages) on a small model: the virtual-clock
  payload equals the reference's field for field, and the numbers the
  card is held to (eos_id=None: the schedule does not depend on the
  model's numbers);
* greedy tokens through ``simulate`` equal the reference's at float32, and
  traffic-driven serving is token-identical to the port's own oracle
  across seeds and arrival processes, paged and contiguous, with EOS
  retirement mid-wave; the EOS id is taken from an observed greedy
  trajectory, not hard-coded.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.serve import AdmissionQueue as JaxAdmissionQueue
from repro.serve import Engine as JaxEngine
from repro.serve import LengthMix as JaxLengthMix
from repro.serve import TrafficProfile as JaxTrafficProfile
from repro.serve import generate_arrivals as jax_generate_arrivals
from repro.serve import simulate as jax_simulate
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve import (
    AdmissionQueue,
    Engine,
    LengthMix,
    Request,
    TrafficProfile,
    generate_arrivals,
    simulate,
)
from repro_torch.serve.traffic import ARRIVALS

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# chip_smoke.py's serve-traffic phase: its profile and pool
CHIP_BURST = dict(
    name="chip-burst-24", num_requests=24, arrival="burst", burst_size=8, num_users=8,
    requests_per_user_tick=0.05, prompt_lens={"choices": [128, 256, 512], "weights": [1, 2, 1]},
    output_lens={"choices": [8, 16, 32], "weights": [1, 2, 1]}, temperature=0.0, deadline=40,
    seed=0)
CHIP_POOL = dict(batch=8, page_size=16, pool_pages=96)
# the JAX package's numbers there (chip_smoke.py holds the card to them)
CHIP_NUMBERS = dict(n_accepted=21, n_rejected=3, n_deadline_rejected=3, generated_tokens=352,
                    decode_steps=91, makespan_ticks=91.0, latency_p50_ticks=31.0,
                    ttft_p50_ticks=15.0, pages_peak_max=34)
HOST_FIELDS = ("wall_s", "tokens_s")  # wall-clock, not virtual


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's default of a thread per core in
    each of them oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profile(cls=TrafficProfile, **over):
    """tests/test_traffic.py:34-43's profile."""
    base = dict(name="t", num_requests=14, arrival="poisson", num_users=10,
                requests_per_user_tick=0.08, prompt_lens=[4, 6],
                output_lens={"choices": [2, 5, 8]}, temperature=0.0, seed=0)
    base.update(over)
    return cls.from_dict(base)


@pytest.fixture(scope="module")
def served():
    """Reduced smollm-135m in the port, bfloat16 (the default CallConfig)."""
    cfg = get_config("smollm-135m").reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


# -------------------- schema --------------------
def test_profile_roundtrip_and_defaults():
    p = profile()
    assert TrafficProfile.from_dict(p.to_dict()) == p
    assert p.to_dict() == profile(JaxTrafficProfile).to_dict()
    assert p.rate == pytest.approx(0.8) and p.max_rows == 6 + 8
    assert ARRIVALS == ("poisson", "uniform", "burst")


@pytest.mark.parametrize("patch", [
    dict(extra_knob=1), dict(arrival="fractal"), dict(num_requests=0), dict(num_users=0),
    dict(requests_per_user_tick=0.0), dict(burst_size=0), dict(temperature=-0.5),
    dict(prompt_lens=[0]), dict(prompt_lens=[4, 4]), dict(deadline=0),
    dict(output_lens={"choices": [2], "weights": [1, 2]}),
    dict(output_lens={"choices": [2], "typo": 1}), dict(output_lens="many"),
    dict(output_lens={"weights": [1]}), dict(name=""),
])
def test_profile_validation_is_the_reference(patch):
    base = profile().to_dict()
    base.update(patch)
    with pytest.raises(ValueError) as got:
        TrafficProfile.from_dict(base)
    with pytest.raises(ValueError) as want:
        JaxTrafficProfile.from_dict(base)
    assert str(got.value) == str(want.value)


def test_missing_fields_and_weights_are_the_reference():
    for cls in (TrafficProfile, JaxTrafficProfile):
        with pytest.raises(ValueError, match=r"missing \['arrival'"):
            cls.from_dict({"name": "x"})
        with pytest.raises(ValueError, match="mapping"):
            cls.from_dict([1])
    mix = LengthMix(choices=[2, 8], weights=[0, 1])  # degenerate: always 8
    assert set(mix.sample(np.random.RandomState(0), 50)) == {8}
    assert np.array_equal(mix.probs, JaxLengthMix(choices=[2, 8], weights=[0, 1]).probs)


# -------------------- arrivals --------------------
def _arrivals(p, vocab, gen):
    return [(a.time, a.request.prompt.tolist(), a.request.max_new_tokens,
             a.request.temperature, a.request.deadline) for a in gen(p, vocab)]


@pytest.mark.parametrize("source", ["traffic_steady.json", "traffic_burst.json", "chip-burst-24"])
@pytest.mark.parametrize("vocab", [512, 49152])
def test_arrivals_equal_the_reference(source, vocab):
    if source == "chip-burst-24":
        mine, ref = TrafficProfile.from_dict(CHIP_BURST), JaxTrafficProfile.from_dict(CHIP_BURST)
    else:
        mine = TrafficProfile.from_json(str(EXAMPLES / source))
        ref = JaxTrafficProfile.from_json(str(EXAMPLES / source))
        assert mine.to_dict() == json.loads((EXAMPLES / source).read_text()) | {
            "burst_size": mine.burst_size, "deadline": None}
    assert mine.to_dict() == ref.to_dict()
    got = _arrivals(mine, vocab, generate_arrivals)
    assert got == _arrivals(ref, vocab, jax_generate_arrivals)
    times = [a[0] for a in got]
    assert times == sorted(times) and len(got) == mine.num_requests
    assert all(len(a[1]) + a[2] <= mine.max_rows for a in got)


def test_burst_arrivals_group():
    p = profile(num_requests=20, arrival="burst", burst_size=8)
    times = [a.time for a in generate_arrivals(p, vocab_size=64)]
    assert times[:8] == [0.0] * 8 and len(set(times)) == 3
    assert times[8] == pytest.approx(8 / p.rate)
    with pytest.raises(ValueError, match="vocab_size must be >= 2"):
        generate_arrivals(p, vocab_size=1)


# -------------------- the virtual clock on the chip's profile --------------------
def test_chip_burst_payload_equals_the_reference():
    """chip_smoke.py's serve-traffic run on a one-layer, 32-wide smollm
    (with eos_id=None the schedule does not depend on the model's numbers),
    without the oracle replay: every virtual-clock field of the payload
    equal."""
    cfg, jcfg = (dataclasses.replace(get("smollm-135m").reduced(), num_layers=1, d_model=32,
                                     num_heads=2, num_kv_heads=1, d_ff=64)
                 for get in (get_config, jax_get_config))
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none"))
    p, jp = TrafficProfile.from_dict(CHIP_BURST), JaxTrafficProfile.from_dict(CHIP_BURST)
    want = jax_simulate(JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), max_seq=jp.max_rows,
                                  **CHIP_POOL), jp, check=False)
    got = simulate(Engine(build_model(cfg, device="cpu", seed=0), max_seq=p.max_rows,
                          **CHIP_POOL), p, check=False)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in HOST_FIELDS} == \
        {k: v for k, v in want.items() if k not in HOST_FIELDS}
    for key, value in CHIP_NUMBERS.items():
        assert got[key] == value, key
    assert got["occupancy"] == pytest.approx(3.637, abs=5e-4)


# -------------------- tokens --------------------
@pytest.mark.parametrize("page_size", [None, 4])
def test_simulated_tokens_equal_the_reference_at_float32(page_size):
    """The same weights and profile through both simulators at float32:
    the same payload and, request for request, the same greedy tokens."""
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(jax_get_config("smollm-135m").reduced(), JaxCallConfig(remat="none", **f32))
    params = jm.init(jax.random.PRNGKey(0))
    tm = model_params_to_port(get_config("smollm-135m").reduced(),
                              jax.tree.map(np.asarray, params),
                              cc=CallConfig(compute_dtype=torch.float32,
                                            cache_dtype=torch.float32), device="cpu")
    p, jp = profile(arrival="burst", burst_size=6), profile(JaxTrafficProfile, arrival="burst",
                                                            burst_size=6)
    jeng = JaxEngine(jm, params, batch=3, max_seq=p.max_rows, page_size=page_size)
    teng = Engine(tm, batch=3, max_seq=p.max_rows, page_size=page_size)
    want = jax_simulate(jeng, jp, check=False)
    got = simulate(teng, p, check=True)
    assert got.pop("matches_sequential")
    assert {k: v for k, v in got.items() if k not in HOST_FIELDS} == \
        {k: v for k, v in want.items() if k not in HOST_FIELDS}
    # the engines' completed requests, in finish order: the same tokens
    arrivals, jarrivals = generate_arrivals(p, 512), jax_generate_arrivals(jp, 512)
    teng.serve(AdmissionQueue(arrivals, max_seq=teng.max_seq), seed=0, do_sample=False)
    jeng.serve(JaxAdmissionQueue(jarrivals, max_seq=jeng.max_seq), seed=0, do_sample=False)
    assert [a.request.out_tokens for a in arrivals] == [a.request.out_tokens for a in jarrivals]


def _eos_from_trajectory(model, p):
    """A token that the greedy model emits mid-stream on this traffic, past
    the first token and before the budget, so EOS retirement is exercised
    by construction (tests/test_traffic.py's EOS id is hard-coded)."""
    arrivals = generate_arrivals(p, model.cfg.vocab_size)
    reqs = [Request(prompt=a.request.prompt.copy(), max_new_tokens=a.request.max_new_tokens)
            for a in arrivals]
    Engine(model, batch=1, max_seq=p.max_rows).generate_sequential(reqs, seed=0)
    longest = max(reqs, key=lambda r: len(r.out_tokens))
    return longest.out_tokens[len(longest.out_tokens) // 2]


@pytest.mark.parametrize("arrival", ["poisson", "burst"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traffic_serving_token_identical_to_oracle(served, arrival, seed):
    """3 seeds x 2 arrival processes, paged KV, EOS mid-wave, FIFO: every
    accepted request's tokens equal the oracle's, replayed with the
    arrival indices."""
    cfg, model = served
    p = profile(arrival=arrival, seed=seed, burst_size=6)
    eos = _eos_from_trajectory(model, p)
    eng = Engine(model, batch=3, max_seq=p.max_rows, eos_id=eos, page_size=4)
    payload = simulate(eng, p, policy="fifo", check=True)
    assert payload["matches_sequential"] and payload["n_accepted"] == p.num_requests
    assert payload["decode_steps"] > 0 and payload["pages_peak_max"] <= -(-p.max_rows // 4)


@pytest.mark.parametrize("page_size", [None, 5])
def test_eos_retirement_mid_wave(served, page_size):
    """A request retires on EOS before its budget, and truncated outputs
    still match the oracle."""
    cfg, model = served
    p = profile(output_lens={"choices": [12]}, num_requests=8, seed=0)
    eos = _eos_from_trajectory(model, p)
    eng = Engine(model, batch=3, max_seq=p.max_rows, eos_id=eos, page_size=page_size)
    arrivals = generate_arrivals(p, cfg.vocab_size)
    done = eng.serve(AdmissionQueue(arrivals, max_seq=eng.max_seq), seed=0, do_sample=False)
    assert any(len(r.out_tokens) < r.max_new_tokens and r.out_tokens[-1] == eos for r in done)
    clones = [Request(prompt=a.request.prompt.copy(), max_new_tokens=a.request.max_new_tokens)
              for a in arrivals]
    ref = eng.generate_sequential(clones, seed=0)
    assert [a.request.out_tokens for a in arrivals] == [c.out_tokens for c in ref]


def test_latency_policy_reorders_but_tokens_match(served):
    cfg, model = served
    p = profile(arrival="burst", burst_size=14, output_lens={"choices": [2, 8]})
    eng = Engine(model, batch=2, max_seq=p.max_rows)
    fifo = simulate(eng, p, policy="fifo", check=True)
    lat = simulate(eng, p, policy="latency", check=True)
    assert fifo["matches_sequential"] and lat["matches_sequential"]
    assert fifo["generated_tokens"] == lat["generated_tokens"]
    assert lat["latency_p50_ticks"] <= fifo["latency_p50_ticks"]


def test_sampled_traffic_matches_the_port_oracle(served):
    """Sampled tokens cannot match the reference's jax.random draws; they
    are held to the port's own oracle, replayed with arrival indices."""
    cfg, model = served
    p = profile(temperature=0.9, seed=4)
    payload = simulate(Engine(model, batch=3, max_seq=p.max_rows, page_size=3), p, check=True)
    assert payload["matches_sequential"] and payload["temperature"] == 0.9


def test_metric_payload_sanity_and_replay(served):
    cfg, model = served
    p = profile(num_requests=16)
    eng = Engine(model, batch=3, max_seq=p.max_rows, page_size=4)
    m = simulate(eng, p, check=False)
    assert m["n_accepted"] + m["n_rejected"] == m["n_requests"]
    assert 0 <= m["ttft_p50_ticks"] <= m["ttft_p99_ticks"] <= m["latency_p99_ticks"]
    assert 0 <= m["latency_p50_ticks"] <= m["latency_p99_ticks"]
    assert m["goodput_tokens_per_tick"] > 0 and m["makespan_ticks"] >= m["decode_steps"]
    assert m["pages_peak_max"] <= -(-p.max_rows // 4) and m["pool_pages"] == 3 * 4
    m2 = simulate(eng, dataclasses.replace(p), check=False)
    assert {k: v for k, v in m.items() if k not in HOST_FIELDS} == \
        {k: v for k, v in m2.items() if k not in HOST_FIELDS}


def test_over_capacity_requests_rejected_not_raised(served):
    cfg, model = served
    p = profile(output_lens={"choices": [2, 30]}, num_requests=10)
    m = simulate(Engine(model, batch=2, max_seq=12), p, check=True)
    assert m["n_rejected"] > 0 and m["n_accepted"] + m["n_rejected"] == 10
    assert m["matches_sequential"]
