"""The port's serve engine, slot cache and admission queue against the JAX
package's.

* greedy ``Engine.generate`` tokens equal the JAX engine's at float32, for
  the same weights (``model_params_to_port``) and prompts;
* batched greedy and sampled outputs equal the port's own
  ``generate_sequential`` (the reference's ``jax.random`` bits cannot be
  reproduced in torch, so sampling is held to the port's oracle);
* EOS retirement and refill, with the EOS id taken from an observed greedy
  trajectory rather than hard-coded;
* ``_validate`` and ``_family_guards`` raise as the reference's do;
* the same for reduced xlstm-350m (the ssm family), whose slot state a
  prefill overwrites whole.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.serve.admission import AdmissionQueue as JaxAdmissionQueue
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve import AdmissionQueue, Engine, Request, batch_axes, cache_bytes, init_slots
from repro_torch.serve.engine import fold_in


def make_requests(vocab, *, n=5, temperature=0.0, max_new=None, seed=0, cls=Request):
    """Ragged prompts and budgets (tests/test_serve.py:34-45)."""
    rng = np.random.RandomState(seed)
    budgets = max_new or [6, 3, 8, 1, 5, 7, 2]
    return [cls(prompt=rng.randint(1, vocab, size=4 + (i % 4)).astype(np.int32),
                max_new_tokens=budgets[i % len(budgets)] if isinstance(budgets, list) else budgets,
                temperature=temperature)
            for i in range(n)]


@pytest.fixture(scope="module")
def served():
    """Reduced smollm-135m in the port, bfloat16 (the default CallConfig)."""
    cfg = get_config("smollm-135m").reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def served_xlstm():
    """Reduced xlstm-350m in the port, bfloat16 (the default CallConfig)."""
    cfg = get_config("xlstm-350m").reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


def _greedy_matches_jax_engine_at_float32(arch):
    cfg = jax_get_config(arch).reduced()
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(cfg, JaxCallConfig(remat="none", **f32))
    params = jm.init(jax.random.PRNGKey(0))
    tm = model_params_to_port(get_config(arch).reduced(), jax.tree.map(np.asarray, params),
                              cc=CallConfig(compute_dtype=torch.float32,
                                            cache_dtype=torch.float32), device="cpu")
    want = JaxEngine(jm, params, batch=2, max_seq=32).generate(
        make_requests(cfg.vocab_size, cls=JaxRequest), seed=0)
    eng = Engine(tm, batch=2, max_seq=32)
    got = eng.generate(make_requests(cfg.vocab_size), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got)
    assert eng.last_stats["prefills"] == len(got)


def test_greedy_generate_matches_jax_engine_at_float32():
    _greedy_matches_jax_engine_at_float32("smollm-135m")


def test_xlstm_greedy_generate_matches_jax_engine_at_float32():
    _greedy_matches_jax_engine_at_float32("xlstm-350m")


def _greedy_batched_matches_sequential(cfg, model):
    eng = Engine(model, batch=2, max_seq=32)
    ref = eng.generate_sequential(make_requests(cfg.vocab_size), seed=0)
    got = eng.generate(make_requests(cfg.vocab_size), seed=0)
    for r, g in zip(ref, got):
        assert g.done and g.out_tokens == r.out_tokens
        assert len(g.out_tokens) == g.max_new_tokens
    # one step advanced every active slot: fewer steps than the oracle's
    seq_steps = sum(max(len(r.out_tokens) - 1, 0) for r in ref)
    assert eng.last_stats["decode_steps"] < seq_steps
    assert eng.last_stats["occupancy"] > 1.0
    assert eng.last_stats["prefills"] == len(ref)
    assert eng.last_stats["admission_order"] == list(range(len(ref)))


def test_greedy_batched_matches_sequential(served):
    _greedy_batched_matches_sequential(*served)


def test_xlstm_greedy_batched_matches_sequential(served_xlstm):
    _greedy_batched_matches_sequential(*served_xlstm)


def test_sampling_batched_matches_sequential_oracle(served):
    cfg, model = served
    eng = Engine(model, batch=2, max_seq=32)
    mk = lambda: make_requests(cfg.vocab_size, n=4, temperature=0.8, max_new=6)  # noqa: E731
    a = eng.generate(mk(), seed=7)
    b = eng.generate(mk(), seed=7)
    ref = eng.generate_sequential(mk(), seed=7)
    other = eng.generate(mk(), seed=8)
    greedy = eng.generate(make_requests(cfg.vocab_size, n=4, max_new=6), seed=7)
    for x, y, r in zip(a, b, ref):
        assert x.out_tokens == y.out_tokens == r.out_tokens
    assert [r.out_tokens for r in other] != [r.out_tokens for r in a]
    assert [r.out_tokens for r in greedy] != [r.out_tokens for r in a]
    # the chain: a fresh key per request, then one fold a step
    assert fold_in(7, 0) != fold_in(7, 1) and fold_in(fold_in(7, 0), 0) != fold_in(7, 0)


def test_eos_retirement_and_refill(served):
    cfg, model = served
    probe = Engine(model, batch=2, max_seq=32)
    first = probe.generate_sequential(make_requests(cfg.vocab_size, n=4, max_new=8), seed=0)
    eos_id = first[0].out_tokens[2]  # a token the greedy model emits mid-stream
    eng = Engine(model, batch=2, max_seq=32, eos_id=eos_id)
    ref = eng.generate_sequential(make_requests(cfg.vocab_size, n=4, max_new=8), seed=0)
    got = eng.generate(make_requests(cfg.vocab_size, n=4, max_new=8), seed=0)
    assert any(len(r.out_tokens) < 8 for r in ref)  # EOS fired
    for r, g in zip(ref, got):
        assert g.done and g.out_tokens == r.out_tokens
        if eos_id in g.out_tokens:  # generation stops at the EOS token
            assert g.out_tokens.index(eos_id) == len(g.out_tokens) - 1
    assert eng.last_stats["admission_order"] == list(range(4))


def _reused_slot_serves_like_a_fresh_one(cfg, model):
    got = Engine(model, batch=1, max_seq=32).generate(
        make_requests(cfg.vocab_size, n=2, max_new=5), seed=0)
    alone = Engine(model, batch=1, max_seq=32).generate_sequential(
        make_requests(cfg.vocab_size, n=2, max_new=5), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in alone]


def test_reused_slot_serves_like_a_fresh_one(served):
    """batch=1 sends request 1 through the slot request 0 just left; its
    rows past the new prompt still hold request 0's values and are never
    read unmasked."""
    _reused_slot_serves_like_a_fresh_one(*served)


def test_xlstm_reused_slot_serves_like_a_fresh_one(served_xlstm):
    """batch=1 sends request 1 through the slot request 0 just left, holding
    request 0's final state (and a parked step's on top): the prefill
    overwrites all seven state leaves, or request 1 would read them."""
    _reused_slot_serves_like_a_fresh_one(*served_xlstm)


def test_xlstm_prefill_overwrites_every_leaf_of_a_slot(served_xlstm):
    cfg, model = served_xlstm
    slots = init_slots(model, 2, 16)
    assert batch_axes(model, 16) == (1,) * 7
    for t in slots.cache:
        t.fill_(7.0)  # a previous occupant's state
    prompt = np.arange(1, 6, dtype=np.int32)[None, :]
    model.prefill(prompt, slots.view(1))
    fresh = model.init_cache(1, 16)
    model.prefill(prompt, fresh)
    assert all(torch.equal(a, b) for a, b in zip(slots.read_slot(1), fresh))
    assert all((t == 7.0).all() for t in slots.read_slot(0))
    slots.reset_slot(1)  # back to the initial state: zeros, m = -1e30
    assert all(torch.equal(a, b) for a, b in zip(slots.read_slot(1), model.init_cache(1, 16)))


def test_slot_cache_views_writes_and_bytes(served):
    cfg, model = served
    assert batch_axes(model, 16) == (1, 1)
    slots = init_slots(model, 2, 16)
    want_bytes = 2 * cfg.num_layers * 2 * 16 * cfg.num_kv_heads * cfg.head_dim * 2  # bf16
    assert cache_bytes(slots.cache) == want_bytes
    one = model.init_cache(1, 16)
    slots.write_prefill(1, tuple(torch.full_like(t, 3) for t in one))
    assert all(torch.equal(t, torch.full_like(t, 3)) for t in slots.read_slot(1))
    assert all(not t.any() for t in slots.read_slot(0))
    slots.view(0)[0].fill_(5)  # a view aliases the pool
    assert torch.equal(slots.cache[0][:, 0], torch.full_like(slots.cache[0][:, 0], 5))
    slots.reset_slot(1)
    assert all(not t.any() for t in slots.read_slot(1))


def test_validate_raises_as_the_reference(served):
    cfg, model = served
    eng = Engine(model, batch=1, max_seq=8)
    with pytest.raises(ValueError, match="cache rows"):
        eng.generate(make_requests(cfg.vocab_size, n=1, max_new=32), seed=0)
    with pytest.raises(ValueError, match="cache rows"):
        eng.generate_sequential(make_requests(cfg.vocab_size, n=1, max_new=32), seed=0)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([Request(prompt=np.zeros((0,), np.int32), max_new_tokens=2)], seed=0)
    bad = make_requests(cfg.vocab_size, n=1)
    bad[0].max_new_tokens = 0
    with pytest.raises(ValueError, match="max_new_tokens=0"):
        eng.generate(bad, seed=0)
    with pytest.raises(ValueError, match="indices"):
        eng.generate_sequential(make_requests(cfg.vocab_size, n=2, max_new=2), indices=[0])
    with pytest.raises(ValueError, match="batch"):
        Engine(model, batch=0, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        Engine(model, batch=1, max_seq=0)
    assert eng.generate([], seed=0) == [] and eng.last_stats["n_requests"] == 0


@pytest.mark.parametrize("arch,batch,match", [
    ("musicgen-large", 1, "generate_sequential"),  # multi-codebook audio
    ("llama-3.2-vision-90b", 1, "image_embeds"),   # vlm needs images
    ("dbrx-132b", 2, "drop-free"),                 # moe capacity drops tokens
])
def test_family_guards_raise_as_the_reference(arch, batch, match):
    """Every family builds in both packages, so the guards are held on real
    reduced models: a wave through each engine raises the same ValueError
    before a slot is filled."""
    cfg = jax_get_config(arch).reduced()
    jm = jax_build_model(cfg, JaxCallConfig(remat="none"))
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(get_config(arch).reduced(), device="cpu", seed=0)
    with pytest.raises(ValueError, match=match):
        JaxEngine(jm, params, batch=batch, max_seq=16).generate(
            make_requests(cfg.vocab_size, n=1, max_new=2, cls=JaxRequest))
    eng = Engine(model, batch=batch, max_seq=16)
    with pytest.raises(ValueError, match=match):
        eng.generate(make_requests(cfg.vocab_size, n=1, max_new=2))
    assert eng._slots is None  # refused before the pool was allocated
    if arch == "dbrx-132b":  # a drop-free capacity passes, in both packages
        big = dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts))
        JaxEngine(jax_build_model(dataclasses.replace(cfg, moe=big), JaxCallConfig()), params,
                  batch=batch, max_seq=16)._family_guards()
        model.cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
            model.cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        Engine(model, batch=batch, max_seq=16)._family_guards()


def test_admission_queue_is_the_reference():
    """The same stream through both queues: the same admissions, in the same
    order, and the same rejections with the same reasons."""
    def stream(cls):
        reqs = [cls(prompt=np.ones(n, np.int32), max_new_tokens=m)
                for n, m in ((3, 4), (0, 2), (5, 1), (4, 30), (2, 0), (6, 3))]
        reqs[5].deadline = 1.5
        return [(float(t), r) for t, r in zip((0, 0, 1, 1, 2, 4), reqs)]

    for policy in ("fifo", "latency"):
        out = []
        for qcls, rcls in ((JaxAdmissionQueue, JaxRequest), (AdmissionQueue, Request)):
            q = qcls(stream(rcls), policy=policy, max_seq=16)
            popped = []
            for now in (0.0, 1.0, 2.0, 3.0, 6.0):
                q.poll(now)
                item = q.pop()
                popped.append(None if item is None else item[0])
            out.append((popped, [(r.index, r.reason, r.time) for r in q.rejected]))
        assert out[0] == out[1]


def test_launcher_serves_on_the_cpu(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3", "--max-new", "4"])
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text and "on cpu" in text


def test_launcher_serves_xlstm_on_the_cpu(capsys):
    serve_main(["--arch", "xlstm-350m", "--reduced", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens" in text and "on cpu" in text
