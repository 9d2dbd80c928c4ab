"""The port's continuous-batching path against the JAX reference (CPU).

Covers chunked-prefill and blockwise attention, the paged decode step,
the page allocator and ``ContinuousServeEngine``.  Reduced configs at
float32; the reference's params are carried over by ``load_jax_params``
and its arm is the ``jnp`` backend.

Tolerances, each with its reason:
  * ``chunk_cache_attention`` / ``_attn_blockwise`` vs the reference:
    rtol 1e-5, atol 1e-6 (exact f32 einsums; torch and XLA sum in other
    orders).  The combine divide itself is bit-exact once both are fed
    the reference's ``acc`` and ``l``.
  * ``decode_paged`` logits: the bound ``ROADMAP.md`` section 3 states
    for ``decode_step`` -- atol 1e-2 under RAPID (the reference's model
    matmuls sum in chunks of 64, the port one k at a time; measured
    maximum 1.6e-3 on minicpm_2b, 4.2e-6 on h2o_danube_1_8b) and 1e-4
    exact (measured maximum 5.2e-7 on minicpm_2b).
  * greedy tokens: 100% equal, to the reference's continuous engine and
    to the port's own lockstep engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import assert_same_bits, randn  # noqa: E402
from repro.configs.base import EXACT as JEXACT  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.scheduler import ContinuousServeEngine as JCont  # noqa: E402
from repro_torch.configs.base import EXACT as TEXACT  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.paged_kv import (SCRATCH_PAGE,  # noqa: E402
                                        PageAllocator, PageGeometry)
from repro_torch.serve.scheduler import (  # noqa: E402
    ContinuousServeEngine, StreamEvent)

CTX = ParallelCtx()
T = torch.from_numpy
MAXI32 = np.iinfo(np.int32).max
# the reference's continuous-engine test set (tests/test_serve.py)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13] * 9]
ENGINE_KW = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4)


def _pair(arch, approx):
    jc = jget(arch).reduced().with_(dtype="float32")
    tc = tget(arch).reduced().with_(dtype="float32")
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    jm, tm = JModel(jc.with_backend("jnp")), TModel(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def port_model():
    """A port-only reduced minicpm_2b (RAPID, f32) for engine behaviour."""
    cfg = tget("minicpm_2b").reduced().with_(dtype="float32", approx=TRAPID)
    model = TModel(cfg)
    return model, model.init(0, "cpu")


def _acfg(approx):
    return (JRAPID, TRAPID) if approx else (JEXACT, TEXACT)


# --------------------------------------------------------------------------
# attention with the online-softmax combine (K5's caller)
# --------------------------------------------------------------------------

def _chunk_case(seed, B=2, S=5, H=4, KV=2, hd=16, C=24):
    rng = np.random.default_rng(seed)
    q = randn(rng, B, S, H, hd)
    kc, vc = randn(rng, B, C, KV, hd), randn(rng, B, C, KV, hd)
    offs = np.array([3, 11])[:B]
    q_pos = (offs[:, None] + np.arange(S)[None]).astype(np.int32)
    kv_len = offs + S
    j = np.arange(C)
    kv_pos = np.where(j[None] < kv_len[:, None], j[None], MAXI32)
    kv_pos = kv_pos.astype(np.int32)
    kv_pos[1, 2] = MAXI32  # an empty slot inside the prefix
    return q, kc, vc, q_pos, kv_pos


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("approx", [True, False])
def test_chunk_cache_attention_vs_reference(window, approx):
    ja, ta = _acfg(approx)
    q, kc, vc, q_pos, kv_pos = _chunk_case(3)
    ref = jlayers.chunk_cache_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), window, ja)
    got = tlayers.chunk_cache_attention(T(q), T(kc), T(vc), T(q_pos),
                                        T(kv_pos), window, ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("approx", [True, False])
def test_online_softmax_combine_bit_exact_on_shared_stats(approx):
    """Fed the same acc and l (zeros and a fully masked row included),
    the combine divide is bit-equal to the reference's."""
    ja, ta = _acfg(approx)
    rng = np.random.default_rng(4)
    acc = randn(rng, 3, 5, 2, 2, 16)
    l = np.abs(randn(rng, 3, 5, 2, 2)) * 7
    l[0, 0] = 0.0
    acc[0, 0] = 0.0
    m = randn(rng, 3, 5, 2, 2)
    ref = jlayers._online_softmax_combine(jnp.asarray(acc), jnp.asarray(l),
                                          jnp.asarray(m), ja)
    got = tlayers._online_softmax_combine(T(acc), T(l), T(m), ta)
    assert_same_bits(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("T_,chunk", [(23, 8), (16, 16), (9, 64)])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("approx", [True, False])
def test_attn_blockwise_vs_reference(T_, chunk, window, approx):
    """Small T with a small chunk: the padded last chunk, causal masking
    and the sliding window, against the reference's scan."""
    ja, ta = _acfg(approx)
    rng = np.random.default_rng(T_ + chunk)
    q = randn(rng, 2, T_, 2, 2, 16)
    k, v = randn(rng, 2, T_, 2, 16), randn(rng, 2, T_, 2, 16)
    pos = np.arange(T_, dtype=np.int32)
    ref = jlayers._attn_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  jnp.asarray(pos), window, True, ja, chunk)
    got = tlayers._attn_blockwise(T(q), T(k), T(v), T(pos), T(pos), window,
                                  True, ta, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_attention_dispatches_blockwise_above_plain_max_t(monkeypatch):
    """Over ``_PLAIN_ATTN_MAX_T`` (lowered to 8 in both packages, a
    test-only patch) prefill attention takes the blockwise path, and the
    logits still agree with the reference's."""
    jm, jp, tm, tp = _pair("h2o_danube_1_8b", True)
    monkeypatch.setattr(jlayers, "_PLAIN_ATTN_MAX_T", 8)
    monkeypatch.setattr(tlayers, "_PLAIN_ATTN_MAX_T", 8)
    calls = []
    real = tlayers._attn_blockwise
    monkeypatch.setattr(tlayers, "_attn_blockwise",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    toks = np.random.default_rng(5).integers(0, 512, (2, 20)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, CTX, 24))(
        jp, jnp.asarray(toks))
    tl, _ = tm.prefill(tp, {"tokens": T(toks)}, 24)
    cfg = tm.cfg
    G = cfg.n_heads // cfg.n_kv_heads
    assert calls == [(2, 20, cfg.n_kv_heads, G, cfg.hd)] * cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2, rtol=0)


# --------------------------------------------------------------------------
# the paged decode step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,approx", [("h2o_danube_1_8b", True),
                                         ("minicpm_2b", True),
                                         ("minicpm_2b", False)])
def test_decode_paged_vs_reference(arch, approx):
    """Two prefill chunks of one slot, then a decode tick over two slots
    (one inactive): logits at each row's last valid token and the pools
    after every write."""
    jm, jp, tm, tp = _pair(arch, approx)
    atol = 1e-2 if approx else 1e-4
    n_pages, PS = 9, 4
    jcache = jm.init_paged_cache(n_pages, PS)
    tcache = tm.init_paged_cache(n_pages, PS, "cpu")
    jstep = jax.jit(lambda p, c, t, pt, o, n: jm.decode_paged(p, t, c, pt, o,
                                                               n, CTX))
    pt = np.array([[3, 5, 1, 0], [0, 0, 0, 0]], np.int32)
    prompt = np.random.default_rng(6).integers(0, 512, 9).astype(np.int32)
    ticks = []
    for off, n in ((0, 6), (6, 3)):  # the second chunk is partly padding
        toks = np.zeros((1, 6), np.int32)
        toks[0, :n] = prompt[off:off + n]
        ticks.append((toks, pt[:1], np.array([off], np.int32),
                      np.array([n], np.int32)))
    ticks.append((np.array([[77], [5]], np.int32), pt,
                  np.array([9, 0], np.int32), np.array([1, 0], np.int32)))
    for toks, ptab, offs, nval in ticks:
        jl, jcache = jstep(jp, jcache, *map(jnp.asarray, (toks, ptab, offs,
                                                          nval)))
        tl, tcache = tm.decode_paged(tp, T(toks), tcache, T(ptab), T(offs),
                                     T(nval))
        live = nval > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=atol, rtol=0)
        for i in range(tm.cfg.n_layers):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    tcache["layers"][i][kv].numpy()[1:],  # page 0 is scratch
                    np.asarray(jcache["layers"][f"l{i}"][kv])[1:],
                    atol=atol, rtol=0)


# --------------------------------------------------------------------------
# the engine against the reference and the lockstep engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,approx", [("h2o_danube_1_8b", True),
                                         ("minicpm_2b", True),
                                         ("minicpm_2b", False)])
def test_continuous_greedy_equals_reference(arch, approx):
    """Mixed prompt lengths, chunked prefill and slot recycling: the
    port's greedy tokens equal the reference engine's, per request."""
    jm, jp, tm, tp = _pair(arch, approx)
    ref = JCont(jm, jp, CTX, backend="jnp", **ENGINE_KW).generate(PROMPTS,
                                                                  max_new=6)
    got = ContinuousServeEngine(tm, tp, **ENGINE_KW).generate(PROMPTS,
                                                              max_new=6)
    assert got == ref


def test_continuous_equals_lockstep_engine(port_model):
    """The counterpart of the reference's fixed-slot parity test: each
    request alone through the lockstep engine gives the same tokens."""
    model, params = port_model
    ref = [TEngine(model, params, cache_n=32).generate([p], max_new=6)[0]
           for p in PROMPTS]
    eng = ContinuousServeEngine(model, params, **ENGINE_KW)
    assert eng.generate(PROMPTS, max_new=6) == ref
    assert eng.alloc.n_free == eng.geom.usable_pages


# --------------------------------------------------------------------------
# allocator and engine behaviour
# --------------------------------------------------------------------------

def test_page_allocator_invariants():
    geom = PageGeometry(page_size=8, n_pages=9, pages_per_slot=4)
    assert (geom.usable_pages, geom.slot_capacity, geom.token_capacity) == \
        (8, 32, 64)
    assert [geom.pages_for(n) for n in (0, 1, 8, 9)] == [1, 1, 1, 2]
    al = PageAllocator(geom)
    a = al.alloc(3)
    b = al.alloc(5)
    assert al.alloc(1) is None and al.n_free == 0 and al.n_live == 8
    assert SCRATCH_PAGE not in a + b
    al.free(a)
    with pytest.raises(ValueError, match="double free"):
        al.free(a)
    al.free(b)
    assert al.n_free == geom.usable_pages and al.n_live == 0
    with pytest.raises(ValueError, match="no usable page"):
        PageGeometry(page_size=8, n_pages=1, pages_per_slot=1)


def test_page_free_list_restored_after_burst(port_model):
    model, params = port_model
    eng = ContinuousServeEngine(model, params, n_slots=2, max_len=32,
                                page_size=4, prefill_chunk=8)
    outs = eng.generate([[1 + i, 2 + i, 3 + i] for i in range(7)], max_new=5)
    assert all(len(o) == 5 for o in outs)
    assert eng.alloc.n_free == eng.geom.usable_pages and eng.alloc.n_live == 0
    assert not eng.pending and (eng.page_table == 0).all()
    assert eng.n_live_tokens == 0


def test_admission_under_full_queue(port_model):
    """More requests than slots: FCFS admission drains the queue as slots
    recycle; mid-flight the queue really is backed up."""
    model, params = port_model
    eng = ContinuousServeEngine(model, params, n_slots=2, max_len=16,
                                page_size=4, n_pages=9, prefill_chunk=4)
    rids = [eng.submit([1 + i, 2 + i], max_new=4) for i in range(6)]
    assert len(eng._queue) == 6  # nothing admitted before the first step
    got = {r: [] for r in rids}

    def drain(events):
        for ev in events:
            assert isinstance(ev, StreamEvent)
            if ev.token is not None:
                got[ev.rid].append(ev.token)

    drain(eng.step())
    assert sum(s is not None for s in eng._slots) == 2
    assert len(eng._queue) == 4
    assert eng.n_live_tokens == 2 + 1  # one prompt prefilled, one decoded
    while eng.pending:
        drain(eng.step())
    assert all(len(got[r]) == 4 for r in rids)


def test_continuous_stop_token_and_max_new_edges(port_model):
    model, params = port_model
    eng = ContinuousServeEngine(model, params, n_slots=2, max_len=16,
                                page_size=4, prefill_chunk=4)
    prompt = [7, 8, 9]  # its free run repeats tokens: [146, 95, 146, ...]
    free = eng.generate([prompt], max_new=6)[0]
    assert len(free) == 6
    # stopping on a token at its first occurrence cuts the run there (a
    # token that occurred earlier would stop at that earlier index)
    fresh = [i for i, t in enumerate(free) if t not in free[:i]]
    assert len(fresh) >= 3
    for cut in fresh:
        out = eng.generate([prompt], max_new=6, stop_token=free[cut])[0]
        assert out == free[:cut] and free[cut] not in out
    # stop on the first sampled token: empty output, one done event
    evs = list(eng.stream([prompt], max_new=6, stop_token=free[0]))
    assert evs == [StreamEvent(eng._next_rid - 1, None, True)]
    # max_new=1 emits exactly one token; the exact capacity fit admits
    evs = list(eng.stream([prompt], max_new=1))
    assert [(e.token, e.done) for e in evs] == [(free[0], True)]
    assert len(eng.generate([[5] * 12], max_new=4)[0]) == 4  # 12+4 == 16
    assert eng.alloc.n_free == eng.geom.usable_pages


@pytest.mark.parametrize("prompt,max_new,match", [
    ([5] * 13, 4, r"13.*4.*17.*16"),
    ([], 4, "non-empty prompt"),
    ([1], 0, "max_new >= 1"),
])
def test_submit_rejects_what_cannot_fit(port_model, prompt, max_new, match):
    model, params = port_model
    eng = ContinuousServeEngine(model, params, n_slots=2, max_len=16,
                                page_size=4)
    with pytest.raises(ValueError, match=match):
        eng.submit(prompt, max_new=max_new)
    small = ContinuousServeEngine(model, params, n_slots=1, max_len=16,
                                  page_size=4, n_pages=3)
    with pytest.raises(ValueError, match="needs 3 pages.*only 2"):
        small.submit([1] * 9, max_new=2)


def test_cancel_queued_and_running(port_model):
    model, params = port_model
    eng = ContinuousServeEngine(model, params, n_slots=1, max_len=16,
                                page_size=4, prefill_chunk=4)
    a = eng.submit([1, 2, 3], max_new=5)
    b = eng.submit([4, 5, 6], max_new=5)
    eng.step()  # a admitted, prefilled and decoding; b queued
    assert eng._slots[0].rid == a and eng.n_live_tokens > 0
    assert eng.cancel(b) and len(eng._queue) == 0
    assert eng.cancel(a) and not eng.pending
    assert not eng.cancel(a)
    assert eng.alloc.n_free == eng.geom.usable_pages
    assert (eng.page_table == 0).all()


def test_continuous_sampling_deterministic_and_independent(port_model):
    """Per-request generators seeded from (seed, rid): a request's sampled
    tokens repeat for a seed and do not depend on its batch mates."""
    model, params = port_model

    def run(prompts, seed=7):
        eng = ContinuousServeEngine(model, params, n_slots=4, max_len=32,
                                    page_size=8, prefill_chunk=4,
                                    temperature=1.0, seed=seed)
        return eng.generate(prompts, max_new=5)

    alone = run([[1, 2, 3]])[0]
    assert run([[1, 2, 3]])[0] == alone
    assert run([[1, 2, 3], [9, 8, 7, 6], [4, 4, 4, 4, 4, 4]])[0] == alone
    assert run([[1, 2, 3]], seed=8)[0] != alone


def test_continuous_rejects_other_families(port_model):
    model, params = port_model

    class Stateful:
        cfg = model.cfg.with_(family="ssm")

    with pytest.raises(ValueError, match="decoder-only text families"):
        ContinuousServeEngine(Stateful(), params)


def test_launcher_continuous_on_cpu(capsys):
    """``launch/serve.py --continuous`` drives the continuous engine: one
    request per slot, ``--max-new`` tokens each."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "minicpm_2b", "--reduced", "--approx",
                       "--device", "cpu", "--continuous", "--batch", "2",
                       "--max-new", "3", "--cache", "16"]) == 0
    out = capsys.readouterr().out
    assert "6 tokens" in out and "continuous" in out
    assert out.count("req") == 2
