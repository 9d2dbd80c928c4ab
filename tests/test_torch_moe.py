"""The port's MoE layer and MoE models against the JAX reference (CPU).

Reduced qwen3_moe_235b_a22b (4 experts, top-2) and llama4_scout_17b_a16e
(4 experts, top-1, the shared expert) at float32 (the layer also at
bfloat16, the serve path's compute dtype), the reference's params
carried over by ``load_jax_params``.  The reference arm is the ``jnp``
backend, its expert matmuls patched on the test side to ``chunk=1``
(its models sum RAPID products in chunks of 64, the port one k at a
time, as the reference's own MoE oracle tests patch them,
``tests/test_shardmap_parity.py``); nothing in ``src/repro`` changes.

Tolerances:

* the MoE layer: expert choices equal, the output within 1e-6 of its
  largest magnitude (measured 1.4e-7: the router logits' and the gate
  row sums' summation orders; outputs of ~650); at bfloat16, within
  2^-8 of it (LAYER_BF16_RTOL);
* models: logits within atol 1e-4 EXACT, 1e-2 RAPID (the dense tests'
  bounds: the attention projections keep the reference's chunk of 64),
  greedy tokens 100% equal in both engines;
* training (RAPID): the dense training bounds
  (``tests/test_torch_train.py``): loss rtol 2e-3, each gradient within
  5e-3 of its leaf's largest magnitude.
"""
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_helpers  # noqa: E402,F401  (torch on one thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.ops import qmatmul_batched as jqmatmul_batched  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import ContinuousServeEngine as JCont  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import (load_jax_params,  # noqa: E402
                                       tree_items)
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousServeEngine  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
ARCHS = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e")
# the lockstep engine's prompts, and the reference's continuous-engine set
LOCK = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13] * 9]
ENGINE_KW = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4)
# the layer's bound, relative to the output's largest magnitude
LAYER_RTOL = 1e-6
# the layer at bf16: 2^-8 of the largest magnitude, at most one bf16 ulp
# there (measured: 0 for qwen3 both arms and llama4 RAPID, 7.4e-4 for
# llama4 EXACT, whose shared expert's exact f32 sums group differently)
LAYER_BF16_RTOL = 2.0 ** -8


@pytest.fixture
def chunk1(monkeypatch):
    """The reference's expert matmuls summed one k at a time (the port's
    order), for as long as the test runs (jitted functions trace inside
    it)."""
    monkeypatch.setattr(jmoe, "qmatmul_batched",
                        partial(jqmatmul_batched, chunk=1))


def _cfgs(arch, approx, scan_layers=False, dtype="float32", **over):
    jc = jget(arch).reduced().with_(dtype=dtype, scan_layers=scan_layers,
                                    **over)
    tc = tget(arch).reduced().with_(dtype=dtype, **over)
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    return jc.with_backend("jnp"), tc


@lru_cache(maxsize=None)
def _init_tree(arch, scan_layers):
    """The reference's seeded init of a reduced model, as numpy (the
    params depend on neither the arithmetic nor the capacity)."""
    jc = jget(arch).reduced().with_(scan_layers=scan_layers)
    return jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))


def _layer(arch, approx, **over):
    """Layer 0's MoE params of the reduced model, both frameworks."""
    jc, tc = _cfgs(arch, approx, **over)
    tree = _init_tree(arch, False)["blocks"]["l0"]["ffn"]
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            load_jax_params(tree, device="cpu"))


def _ref_layer(x, jp, jc, dtype=jnp.float32):
    """The reference's ``moe_ffn`` (single device), jitted, on ``x`` in
    ``dtype``; the output as f32."""
    return np.asarray(jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jc, CTX))(
        jnp.asarray(x, dtype), jp)).astype(np.float32)


def _pair(arch, approx, scan_layers=False, **over):
    jc, tc = _cfgs(arch, approx, scan_layers=scan_layers, **over)
    tree = _init_tree(arch, scan_layers)
    tp = load_jax_params(tree, device="cpu")
    return JModel(jc), jax.tree.map(jnp.asarray, tree), TModel(tc), tp


def _ref_experts(x, router, k):
    """The reference's expert ids: ``jax.lax.top_k`` of its f32 logits."""
    logits = jnp.einsum("td,de->te", jnp.asarray(x), jnp.asarray(router))
    return np.asarray(jax.lax.top_k(logits, k)[1]), np.asarray(logits)


def _margin(logits, k):
    """The smallest gap between a token's k-th and (k+1)-th logit."""
    s = -np.sort(-logits, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[1] > k else np.inf


# --------------------------------------------------------------------------
# config, params and the router
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_load_jax_params_carries_the_moe_tree(arch, scan_layers):
    """The reference's reduced MoE tree, stacked or ``l{i}``, arrives
    leaf for leaf in the port's own spec tree (router, the expert
    stacks, llama4's shared expert)."""
    jm, jp, tm, tp = _pair(arch, False, scan_layers=scan_layers)
    want = jax.tree.map(np.asarray, jp)

    def paths(t, pre=()):
        if isinstance(t, dict):
            return {q for k, v in t.items() for q in paths(v, pre + (k,))}
        if isinstance(t, list):
            return {q for i, v in enumerate(t) for q in paths(v, pre + (i,))}
        return {pre}
    assert paths(tp) == paths(tm.param_specs())
    cfg = tm.cfg
    for i, blk in enumerate(tp["blocks"]):
        ffn = blk["ffn"]
        assert ("shared" in ffn) == cfg.shared_expert
        assert tuple(ffn["w1"].shape) == (cfg.n_experts, cfg.d_model,
                                          cfg.d_ff)
        ref = (jax.tree.map(lambda a: a[i], want["blocks"]) if scan_layers
               else want["blocks"][f"l{i}"])
        for (path, got) in tree_items(ffn):
            leaf = ref["ffn"]
            for key in path:
                leaf = leaf[key]
            np.testing.assert_array_equal(got.numpy(), leaf)


def test_top_k_takes_the_lower_expert_on_a_tie():
    """``jax.lax.top_k``'s rule: among equal logits the lower index
    first; ``torch.topk`` gives other ids here."""
    logits = np.array([[0.5, 0.7, 0.7, 0.7]], np.float32)
    _, idx = tmoe._top_k(T(logits), 2)
    assert idx.tolist() == [[1, 2]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1]).tolist() \
        == [[1, 2]]
    rng = np.random.default_rng(0)
    many = rng.integers(0, 3, (64, 8)).astype(np.float32)  # ties everywhere
    for k in (1, 2, 8):
        val, idx = tmoe._top_k(T(many), k)
        jval, jidx = jax.lax.top_k(jnp.asarray(many), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))


@pytest.mark.parametrize("approx", [False, True])
def test_tied_router_picks_the_references_experts(approx, chunk1):
    """Experts 1-3 with one router column: every token's logits tie
    among them, so top-2 takes the lower ids; the layer's output (which
    the gates and the capacity drops order) equals the reference's."""
    jc, jp, tc, tp = _layer("qwen3_moe_235b_a22b", approx)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 3] = router[:, 1]
    router[:, 0] -= 1.0  # expert 0 below the tied three
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=T(router))
    x = np.abs(np.random.default_rng(2).normal(size=(2, 8, 128))
               ).astype(np.float32)
    ids, _ = _ref_experts(x.reshape(16, 128), router, 2)
    assert (ids == [1, 2]).all()
    _, got_ids = tmoe._top_k(T(x.reshape(16, 128)) @ T(router), 2)
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    ref = _ref_layer(x, jp, jc)
    got = tmoe.moe_ffn(T(x), tp, tc).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=LAYER_RTOL * np.abs(ref).max())


def test_capacity_overflow_drops_the_references_slots(chunk1):
    """Every token's first choice is expert 0 at the default capacity
    factor: 16 tokens x top-2 over 4 experts gives 10 slots an expert,
    so the last 6 tokens (in the stable sort's order) lose expert 0.
    The output equals the reference's; against a run with room for all,
    exactly those 6 tokens change."""
    jc, jp, tc, tp = _layer("qwen3_moe_235b_a22b", True)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 0.5
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=T(router))
    x = np.abs(np.random.default_rng(3).normal(size=(2, 8, 128))
               ).astype(np.float32)
    ids, _ = _ref_experts(x.reshape(16, 128), router, 2)
    assert (ids[:, 0] == 0).all()
    assert tmoe.capacity(16, tc) == 10
    ref = _ref_layer(x, jp, jc)
    got = tmoe.moe_ffn(T(x), tp, tc).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=LAYER_RTOL * np.abs(ref).max())
    roomy = tmoe.moe_ffn(T(x), tp, tc.with_(capacity_factor=8.0)).numpy()
    changed = np.abs(roomy - got).reshape(16, -1).max(axis=1) > 0
    assert changed.tolist() == [False] * 10 + [True] * 6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("approx", [False, True])
def test_moe_ffn_matches_reference(arch, approx, chunk1):
    """The layer on 2 x 12 tokens: the same experts as the reference's,
    the output within LAYER_RTOL of its largest magnitude."""
    jc, jp, tc, tp = _layer(arch, approx)
    x = np.random.default_rng(1).normal(size=(2, 12, 128)).astype(np.float32)
    k = tc.experts_per_token
    ids, logits = _ref_experts(x.reshape(24, 128), np.asarray(jp["router"]),
                               k)
    _, got_ids = tmoe._top_k(T(x.reshape(24, 128)) @ tp["router"], k)
    print(f"{arch}: smallest top-{k} margin {_margin(logits, k):.3e}")
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    ref = _ref_layer(x, jp, jc)
    got = tmoe.moe_ffn(T(x), tp, tc).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=LAYER_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("approx", [False, True])
def test_moe_ffn_bf16_matches_reference(arch, approx, chunk1):
    """The layer at the serve path's compute dtype, bfloat16, on 2 x 12
    tokens: the reference's roundings (the expert stacks cast to bf16,
    the bf16 buffer, ``g1 * h3`` in f32 cast to bf16, the bf16 output)
    against the reference's ``moe_ffn``; the same experts, the output
    within LAYER_BF16_RTOL of its largest magnitude."""
    jc, jp, tc, tp = _layer(arch, approx, dtype="bfloat16")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 12, 128)).astype(np.float32)).to(torch.bfloat16)
    xf = x.float().numpy()  # the bf16 values, exactly
    k = tc.experts_per_token
    ids, logits = _ref_experts(xf.reshape(24, 128), np.asarray(jp["router"]),
                               k)
    _, got_ids = tmoe._top_k(x.float().reshape(24, 128) @ tp["router"], k)
    print(f"{arch}: smallest top-{k} margin {_margin(logits, k):.3e}")
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    ref = _ref_layer(xf, jp, jc, jnp.bfloat16)
    got = tmoe.moe_ffn(x, tp, tc)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == xf.shape
    got = got.float().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{arch} approx={approx}: bf16 max |diff| / max |ref| {rel:.3e}")
    assert rel <= LAYER_BF16_RTOL


# --------------------------------------------------------------------------
# the models and the engines
# --------------------------------------------------------------------------

def _padded(prompts):
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p  # left-pad, as the engines
    return toks


@pytest.mark.parametrize("arch,approx", [("qwen3_moe_235b_a22b", True),
                                         ("qwen3_moe_235b_a22b", False),
                                         ("llama4_scout_17b_a16e", False)])
def test_logits_and_greedy_tokens_match_reference(arch, approx, chunk1):
    """``forward``, ``prefill``, ``decode_step`` and ``decode_paged`` (a
    prefill chunk and a decode tick) against the reference's, through
    the reference engines' own compiled steps, at the shapes the engines
    then run; then both engines' greedy tokens against the reference
    engines': the lockstep engine on three prompts, the continuous
    engine on the reference's four through two slots (chunked prefill,
    slot recycling).  Capacity factor 8: no drops, as the reference's
    serve tests.  llama4's RAPID layer is held by
    ``test_moe_ffn_matches_reference``; its model here runs EXACT (a
    RAPID model case costs ~8x an EXACT one on the CPU: the reference's
    compiles and the plain K1 over capacity-8 buffers)."""
    jm, jp, tm, tp = _pair(arch, approx, capacity_factor=8.0)
    atol = 1e-2 if approx else 1e-4
    toks = _padded(LOCK)

    jl = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, CTX))(
        jp, jnp.asarray(toks))
    tl = tm.forward(tp, {"tokens": T(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)

    jeng = JEngine(jm, jp, CTX, cache_n=32)
    jl, jc = jeng._prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": T(toks)}, 32)
    for _ in range(2):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        nt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(tl.numpy().argmax(-1), nt)
        jl, jc = jeng._decode(jp, jnp.asarray(nt), jc)
        tl, tc = tm.decode_step(tp, T(nt), tc)
    ref = jeng.generate(LOCK, max_new=4)
    assert TEngine(tm, tp, cache_n=32).generate(LOCK, max_new=4) == ref

    jeng = JCont(jm, jp, CTX, backend="jnp", **ENGINE_KW)
    jcache = jm.init_paged_cache(9, 8)
    tcache = tm.init_paged_cache(9, 8, "cpu")
    pt = np.array([[3, 5, 1, 0], [2, 0, 0, 0]], np.int32)
    ticks = [(jeng._prefill, np.array([[4, 5, 6, 7]], np.int32), pt[:1],
              np.array([0], np.int32), np.array([4], np.int32)),
             (jeng._decode, np.array([[77], [5]], np.int32), pt,
              np.array([4, 0], np.int32), np.array([1, 0], np.int32))]
    for jstep, tk, ptab, offs, nval in ticks:
        jl, jcache = jstep(jp, jcache, *map(jnp.asarray, (tk, ptab, offs,
                                                           nval)))
        tl, tcache = tm.decode_paged(tp, T(tk), tcache, T(ptab), T(offs),
                                     T(nval))
        live = nval > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=atol, rtol=0)
    ref = jeng.generate(PROMPTS, max_new=4)
    eng = ContinuousServeEngine(tm, tp, **ENGINE_KW)
    assert eng.generate(PROMPTS, max_new=4) == ref
    assert eng.trace_counts == {"decode": 1, "prefill": 1}


def test_greedy_tokens_with_capacity_drops_equal_reference(chunk1):
    """The default capacity factor (1.25), RAPID: the lockstep prefill
    drops pairs (18 tokens x top-2 over 4 experts, 12 slots an expert)
    and so does a continuous decode tick (2 tokens, 2 slots); prefill
    logits within the dense bound, greedy tokens 100% equal in both
    engines."""
    jm, jp, tm, tp = _pair("qwen3_moe_235b_a22b", True)
    assert tm.cfg.capacity_factor == 1.25
    toks = _padded(LOCK)
    jeng = JEngine(jm, jp, CTX, cache_n=32)
    jl, _ = jeng._prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": T(toks)}, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2, rtol=0)
    ref = jeng.generate(LOCK, max_new=4)
    assert TEngine(tm, tp, cache_n=32).generate(LOCK, max_new=4) == ref
    ref = JCont(jm, jp, CTX, backend="jnp", **ENGINE_KW).generate(PROMPTS,
                                                                  max_new=4)
    assert ContinuousServeEngine(tm, tp, **ENGINE_KW).generate(
        PROMPTS, max_new=4) == ref


def test_loss_and_grads_match_reference(chunk1):
    """Reduced qwen3_moe_235b_a22b, RAPID, capacity factor 8: the loss
    and every gradient leaf (router and expert stacks included) against
    ``jax.grad``, within the dense training bounds."""
    from repro.data.pipeline import SyntheticLM
    jm, jp, tm, tp = _pair("qwen3_moe_235b_a22b", True, capacity_factor=8.0)
    batch = SyntheticLM(512, 16, 2, seed=1).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, CTX)))(jp, batch)
    leaves = [p for _, p in tree_items(tp)]
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss_fn(tp, {k: T(np.array(v)) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-3)
    want = load_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    for (path, w), g in zip(tree_items(want), grads):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=5e-3 * float(w.abs().max()) + 1e-12,
            err_msg=str(path))


def test_launchers_take_the_moe_archs(capsys):
    """``launch/serve.py`` serves both MoE configs reduced on the CPU,
    through each engine."""
    from repro_torch.launch import serve
    for arch, extra in (("qwen3_moe_235b_a22b", []),
                        ("llama4_scout_17b_a16e", ["--continuous"])):
        assert serve.main(["--arch", arch, "--reduced", "--approx",
                           "--device", "cpu", "--batch", "2",
                           "--max-new", "3", "--cache", "16"] + extra) == 0
        out = capsys.readouterr().out
        assert "6 tokens" in out and out.count("req") == 2
