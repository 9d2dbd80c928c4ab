"""The port's vlm family (llava_next_34b) against the JAX reference (CPU,
plain torch).

Reduced llava_next_34b: 2 layers, d_model 128, 4 / 2 heads of 32, rms,
the silu-gated MLP, vocab 512, ``frontend_seq`` 8 patches, with the
reference's params carried over by ``load_jax_params``.  Inputs: patch
embeddings [B, 8, 1024] (x 0.1, as the reference's tests scale them) and
prompts from a numpy seed.  The reference arm is the jitted ``jnp``
backend with its weight matmuls summed one k at a time (``chunk1``:
``qmatmul`` patched on the test side to ``chunk=1``, the port's K order,
as ``tests/test_torch_encdec.py`` does); nothing in ``src/repro``
changes.

Tolerances (measured worst cases in brackets):

* the projector (``_project``: two exact f32 products, the tanh gelu
  between), f32, on the same patches: within PROJ_RTOL 1e-6 of the
  output's largest magnitude [4.6e-7].  XLA's tanh gelu differs from
  torch's in the last bits (ROADMAP rule 4): within 2 ulp on the same
  product [2 ulp, on 7.5% of elements]; the second product fed the
  reference's own gelu output within PROJ_RTOL [0];
* logits, f32 (forward, prefill, 8 greedy decode steps, the ring that
  drops patches, ``decode_paged``) and the caches' k / v: EXACT within
  EXACT_RTOL 2e-5 of the largest magnitude [1.6e-6]; RAPID within
  RAPID_RTOL 1e-2 [6.0e-3 at the seventh decode step; forward 5.5e-3,
  prefill's k / v 3.7e-3, the ring 1.3e-3, ``decode_paged`` 8.9e-7 on
  tokens alone]: the projector's few-ulp differences cross RAPID
  coefficient cells in the first block's products;
* ``loss_fn`` (the patch positions dropped) within the same bounds,
  relative [EXACT 7.1e-8, RAPID 1.4e-4];
* the two blocks fed the reference's own stream (its concatenated
  patches and tokens): EXACT and RAPID within EXACT_RTOL [5.6e-7 /
  8.2e-7], so the RAPID gap above comes from the projector's ulps;
* bf16 activations and KV against the reference compiled with XLA's
  excess precision off: logits within BF16_RTOL 2^-6 [EXACT 7.7e-3,
  RAPID 1.0e-2: a bf16 ulp is 2^-8 of a value];
* greedy tokens: 100% equal over prefill and 8 decode steps, EXACT and
  RAPID, f32 and bf16.
"""
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import _strict, ulp_diff  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params, tree_items  # noqa: E402
from repro_torch.serve.compiled import CompiledStep  # noqa: E402
from repro_torch.serve.scheduler import ContinuousServeEngine  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
ARCH = "llava_next_34b"
B, S, CACHE_N, STEPS = 2, 7, 32, 8
PROJ_RTOL = 1e-6
EXACT_RTOL = 2e-5
RAPID_RTOL = 1e-2
BF16_RTOL = 2.0 ** -6


@pytest.fixture(scope="module", autouse=True)
def chunk1():
    """The reference's weight matmuls summed one k at a time (the port's
    order) for the whole module: its jitted functions trace inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "qmatmul", partial(jops.qmatmul, chunk=1))
        yield


def _cfgs(approx, dtype="float32", **over):
    jc = jget(ARCH).reduced().with_(dtype=dtype, **over)
    tc = tget(ARCH).reduced().with_(dtype=dtype, **{
        k: v for k, v in over.items() if k != "scan_layers"})
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    return jc.with_backend("jnp"), tc


@lru_cache(maxsize=None)
def _tree(**over):
    """The reference's seeded init as numpy."""
    jc = _cfgs(False, **over)[0]
    return jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))


def _pair(approx, dtype="float32", **over):
    jc, tc = _cfgs(approx, dtype, **over)
    tree = _tree(**over)
    return (JModel(jc), jax.tree.map(jnp.asarray, tree), TModel(tc),
            load_jax_params(tree, device="cpu"))


def _inputs(seed=0, batch=B, prompt=S, patches=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (batch, prompt)).astype(np.int32)
    pat = (0.1 * rng.standard_normal((batch, patches, 1024))).astype(
        np.float32)
    return toks, pat


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _rtol(approx):
    return RAPID_RTOL if approx else EXACT_RTOL


# --------------------------------------------------------------------------
# config, params, cache layout
# --------------------------------------------------------------------------

def test_config_and_reduced_match_reference():
    """llava_next_34b field for field (60 layers, 7168 wide, 56 / 8 heads
    of 128, d_ff 20480, vocab 64000, rope theta 5e6, rms, silu, an
    untied head, 576 patches), and ``reduced()`` as the reference's: 2
    layers, d 128, 4 / 2 heads of 32, 8 patches."""
    assert ARCH in ARCH_IDS
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab_size", "head_dim", "act", "norm", "norm_eps",
              "rope_theta", "sliding_window", "tie_embeddings", "n_experts",
              "frontend_seq", "dtype", "param_dtype", "remat")
    for full, ref in ((tget(ARCH), jget(ARCH)),
                      (tget(ARCH).reduced(), jget(ARCH).reduced())):
        for f in fields:
            assert getattr(full, f) == getattr(ref, f), f
    red = tget(ARCH).reduced()
    assert (red.n_layers, red.d_model, red.n_heads, red.n_kv_heads,
            red.hd, red.frontend_seq) == (2, 128, 4, 2, 32, 8)
    full = tget(ARCH)
    assert (full.family, full.n_heads // full.n_kv_heads, full.hd,
            full.frontend_seq) == ("vlm", 7, 128, 576)


def test_full_param_specs_match_reference_shapes():
    """``Model(llava_next_34b).param_specs()`` against the reference's
    ``param_shapes()`` (its stacked layers unstacked) path for path and
    shape for shape, the projector's w1 [1024, 7168] and w2 [7168, 7168]
    included: 34 447 637 504 params, nothing allocated."""
    specs = TModel(tget(ARCH)).param_specs()
    got = {p: tuple(s.shape) for p, s in tree_items(specs)}
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            JModel(jget(ARCH)).param_shapes())[0]:
        keys = tuple(k.key for k in path)
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                ref[(keys[0], i) + keys[1:]] = tuple(leaf.shape[1:])
        else:
            ref[keys] = tuple(leaf.shape)
    assert got == ref
    assert got[("projector", "w1")] == (1024, 7168)
    assert got[("projector", "w2")] == (7168, 7168)
    assert sum(int(np.prod(s)) for s in got.values()) == 34_447_637_504


@pytest.mark.parametrize("scan_layers", [False, True])
def test_load_jax_params_carries_the_projector(scan_layers):
    """The reference's tree, keyed ``l{i}`` or stacked, arrives leaf for
    leaf in the port's own spec tree, the ``projector`` subtree (w1, w2)
    included, the reference's values in each."""
    jc = _cfgs(False, scan_layers=scan_layers)[0]
    tree = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(1)))
    tp = load_jax_params(tree, device="cpu")
    specs = TModel(_cfgs(False)[1]).param_specs()
    assert [p for p, _ in tree_items(tp)] == [p for p, _ in tree_items(
        specs)]
    want = dict(tree)
    want["blocks"] = [jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
                      if scan_layers else tree["blocks"][f"l{i}"]
                      for i in range(2)]
    for path, got in tree_items(tp):
        leaf = want
        for key in path:
            leaf = leaf[key]
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=str(path))
    assert sorted(tp["projector"]) == ["w1", "w2"]
    assert tuple(tp["projector"]["w1"].shape) == (1024, 128)
    assert tuple(tp["projector"]["w2"].shape) == (128, 128)


def test_init_cache_matches_reference_layout():
    """The decode cache has the reference's keys and no other (``pos``,
    ``slots``, per layer ``k`` / ``v``: the dense ring, no cross k/v), in
    the config's dtype, zero."""
    ref = JModel(jget(ARCH).reduced()).init_cache(3, 24)
    cache = TModel(tget(ARCH).reduced()).init_cache(3, 24, "cpu")
    assert sorted(cache) == sorted(ref) == ["layers", "pos", "slots"]
    np.testing.assert_array_equal(cache["slots"].numpy(),
                                  np.asarray(ref["slots"]))
    assert len(cache["layers"]) == len(ref["layers"]) == 2
    for lc in cache["layers"]:
        assert sorted(lc) == sorted(ref["layers"]["l0"]) == ["k", "v"]
        for k, t in lc.items():
            assert tuple(t.shape) == ref["layers"]["l0"][k].shape, k
            assert t.dtype == torch.bfloat16 and not t.any()


def test_continuous_engine_and_launcher_refuse_vlm():
    """``ContinuousServeEngine`` refuses the vlm family with the
    reference's "dense/moe" message (no engine carries ``patches``), and
    so does the launcher."""
    from repro_torch.launch import serve
    _, _, tm, tp = _pair(False)
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousServeEngine(tm, tp)
    with pytest.raises(ValueError, match="pure-text archs"):
        serve.check_servable(tm.cfg)


# --------------------------------------------------------------------------
# the projector
# --------------------------------------------------------------------------

def test_projector_matches_reference():
    """``_project`` on the same patches against the reference's projector
    (the einsum, ``jax.nn.gelu``'s tanh form, the einsum), f32: within
    PROJ_RTOL of the output's largest magnitude; the tanh gelu on the
    same product within 2 ulp, and the second product, fed the
    reference's own gelu output, within PROJ_RTOL."""
    _, _, tm, tp = _pair(False)
    pr = _tree()["projector"]
    _, pat = _inputs()

    def ref_parts(pat, w1, w2):
        h = jnp.einsum("bpe,ed->bpd", pat, w1)
        g = jax.nn.gelu(h)
        return h, g, jnp.einsum("bpd,de->bpe", g, w2)

    h, g, out = map(np.array, jax.jit(ref_parts)(pat, pr["w1"], pr["w2"]))
    got = tm._project(tp, T(pat))
    assert got.dtype == torch.float32 and got.shape == (B, 8, 128)
    th = torch.nn.functional.gelu(T(h), approximate="tanh").numpy()
    gelu_ulp = int(ulp_diff(th, g).max())
    second = _rel(torch.einsum("bpd,de->bpe", T(g), T(np.array(pr["w2"]))),
                  out)
    rel = _rel(got, out)
    print(f"projector rel {rel:.2e}; gelu {gelu_ulp} ulp, "
          f"{(ulp_diff(th, g) > 0).mean():.1%} of elements differ; second "
          f"product on the reference's gelu rel {second:.2e}")
    assert gelu_ulp <= 2
    assert second <= PROJ_RTOL
    assert rel <= PROJ_RTOL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _reference_run(approx):
    """The reference on ``_inputs()``, as numpy: forward logits, the loss,
    prefill logits and cache, then STEPS greedy decode steps (logits,
    tokens)."""
    jm, jp, _, _ = _pair(approx)
    toks, pat = _inputs()
    tgt = np.roll(toks, -1, 1)
    tgt[:, -1] = -1
    batch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(pat),
             "targets": jnp.asarray(tgt)}
    fwd = np.asarray(jax.jit(lambda p, b: jm.forward(p, b, CTX))(jp, batch))
    loss = float(jax.jit(lambda p, b: jm.loss_fn(p, b, CTX))(jp, batch))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, CTX, CACHE_N))(jp, batch)
    cache = jax.tree.map(np.asarray, jc)
    dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))
    logits, tokens = [np.asarray(jl)], []
    for _ in range(STEPS):
        nt = np.asarray(jl).argmax(-1).astype(np.int32)
        tokens.append(nt)
        jl, jc = dec(jp, jnp.asarray(nt), jc)
        logits.append(np.asarray(jl))
    return fwd, loss, cache, logits, tokens


@pytest.mark.parametrize("approx", [False, True])
def test_forward_and_loss_match_reference(approx):
    """``forward`` over the patches and the prompt (logits at every one of
    the 8 + S positions) and ``loss_fn`` (the patch positions dropped:
    the targets cover the prompt) within the stated bound of the
    reference's."""
    fwd, loss, _, _, _ = _reference_run(approx)
    _, _, tm, tp = _pair(approx)
    toks, pat = _inputs()
    tgt = np.roll(toks, -1, 1)
    tgt[:, -1] = -1
    batch = {"tokens": T(toks), "patches": T(pat), "targets": T(tgt)}
    got = tm.forward(tp, batch)
    assert got.shape == (B, 8 + S, 512)
    rel = _rel(got, fwd)
    tl = float(tm.loss_fn(tp, batch))
    print(f"approx={approx}: forward rel {rel:.2e}, loss {tl} vs {loss} "
          f"(rel {abs(tl - loss) / abs(loss):.2e})")
    assert rel <= _rtol(approx)
    assert abs(tl - loss) <= _rtol(approx) * abs(loss)


@pytest.mark.parametrize("approx", [False, True])
def test_blocks_on_reference_stream(approx):
    """The two blocks fed the reference's own stream (the projected
    patches ahead of the token embeddings, as the reference concatenates
    them), positions over both: each block's output and k / v within
    EXACT_RTOL, RAPID too (the RAPID products are the same bits on equal
    operands)."""
    jc, tc = _cfgs(approx)
    tree = _tree()
    toks, pat = _inputs()
    jm = JModel(jc)
    jp = jax.tree.map(jnp.asarray, tree)

    def stream(p, t, pt):
        x = jm._embed(p, t)
        pr = p["projector"]
        g = jax.nn.gelu(jnp.einsum("bpe,ed->bpd", pt, pr["w1"]))
        g = jnp.einsum("bpd,de->bpe", g, pr["w2"])
        return jnp.concatenate([g.astype(x.dtype), x], axis=1)

    x = np.asarray(jax.jit(stream)(jp, toks, pat))
    pos = np.arange(8 + S, dtype=np.int32)
    worst = 0.0
    for i in range(2):
        lp = tree["blocks"][f"l{i}"]
        out, kv = jax.jit(lambda x, lp: jtr.block_apply(
            x, lp, jc, CTX, jnp.asarray(pos), norm_kind="rms",
            return_kv=True))(x, jax.tree.map(jnp.asarray, lp))
        tout, tkv = ttr.block_apply(T(x), load_jax_params(lp, device="cpu"),
                                    tc, T(pos))
        rel = [_rel(tout, out)] + [_rel(a, b) for a, b in zip(tkv, kv)]
        worst = max(worst, *rel)
        x = np.asarray(out)
    print(f"approx={approx}: blocks on the reference's stream rel {worst:.2e}")
    assert worst <= EXACT_RTOL


@pytest.mark.parametrize("approx", [False, True])
def test_prefill_and_greedy_decode_match_reference(approx):
    """``prefill`` over 8 patches and S prompt tokens: logits within the
    bound, ``pos`` = 8 + S, the slots the reference's, every layer's k / v
    at the patch and token positions within the bound (the ring's
    unwritten slots zero); then STEPS greedy ``decode_step``s through a
    ``CompiledStep`` (one trace), each side on its own tokens: every
    step's logits within the bound and the tokens 100% equal."""
    _, _, jcache, jlogits, jtokens = _reference_run(approx)
    _, _, tm, tp = _pair(approx)
    rtol = _rtol(approx)
    toks, pat = _inputs()
    tl, cache = tm.prefill(tp, {"tokens": T(toks), "patches": T(pat)},
                           CACHE_N)
    assert int(cache["pos"]) == int(jcache["pos"]) == 8 + S
    np.testing.assert_array_equal(cache["slots"].numpy(), jcache["slots"])
    worst = 0.0
    for i, lc in enumerate(cache["layers"]):
        ref = jcache["layers"][f"l{i}"]
        assert sorted(lc) == sorted(ref) == ["k", "v"]
        for k, t in lc.items():
            assert tuple(t.shape) == ref[k].shape, k
            got = t.float().numpy()
            assert not got[:, 8 + S:].any()
            worst = max(worst, _rel(got[:, :8 + S], ref[k][:, :8 + S]))
    trace_counts = {"decode": 0}
    step = CompiledStep("decode", trace_counts, "cpu")
    diffs = []
    for i, want in enumerate(jlogits):
        diffs.append(_rel(tl, want))
        if i == STEPS:
            break
        nt = tl.numpy().argmax(-1).astype(np.int32)
        assert np.array_equal(nt, jtokens[i]), i
        tl = step(lambda t: tm.decode_step(tp, t, cache)[0], T(nt), key=0)
    print(f"approx={approx}: cache k/v rel {worst:.2e}; prefill + {STEPS} "
          f"decode steps rel {[f'{d:.1e}' for d in diffs]}")
    assert worst <= rtol
    assert max(diffs) <= rtol
    assert trace_counts == {"decode": 1}
    assert int(cache["pos"]) == 8 + S + STEPS


@pytest.mark.parametrize("approx", [False, True])
def test_prefill_ring_drops_patches(approx):
    """``cache_n`` 12 below 8 patches + 7 tokens: the ring keeps the last
    12 positions (the first 3 patches dropped), as the reference's: the
    same slots, logits and k / v within the bound, then 4 greedy decode
    steps with equal tokens."""
    jm, jp, tm, tp = _pair(approx)
    rtol = _rtol(approx)
    toks, pat = _inputs(seed=3)
    jl, jc = jax.jit(lambda p, t, pt: jm.prefill(
        p, {"tokens": t, "patches": pt}, CTX, 12))(jp, toks, pat)
    tl, tc = tm.prefill(tp, {"tokens": T(toks), "patches": T(pat)}, 12)
    np.testing.assert_array_equal(tc["slots"].numpy(), np.asarray(
        jc["slots"]))
    assert sorted(tc["slots"][0].tolist()) == list(range(3, 15))
    worst = [_rel(tl, jl)]
    for i, lc in enumerate(tc["layers"]):
        for k, t in lc.items():
            worst.append(_rel(t.float(), jc["layers"][f"l{i}"][k]))
    dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))
    for _ in range(4):
        nt = tl.numpy().argmax(-1).astype(np.int32)
        assert np.array_equal(nt, np.asarray(jl).argmax(-1))
        jl, jc = dec(jp, jnp.asarray(nt), jc)
        tl, tc = tm.decode_step(tp, T(nt), tc)
        worst.append(_rel(tl, jl))
    print(f"approx={approx}: ring of 12 rel {max(worst):.2e}")
    assert max(worst) <= rtol


@pytest.mark.parametrize("approx", [False, True])
def test_decode_paged_matches_reference(approx):
    """``init_paged_cache`` and ``decode_paged`` on the vlm family (on
    tokens, as the reference's): two prefill chunks of one slot, then a
    decode tick over two slots (one inactive): logits at each row's last
    valid token and the pools after every write within the bound."""
    jm, jp, tm, tp = _pair(approx)
    rtol = _rtol(approx)
    n_pages, PS = 9, 4
    jcache = jm.init_paged_cache(n_pages, PS)
    tcache = tm.init_paged_cache(n_pages, PS, "cpu")
    assert len(tcache["layers"]) == 2
    jstep = jax.jit(lambda p, c, t, pt, o, n: jm.decode_paged(
        p, t, c, pt, o, n, CTX))
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
    worst = 0.0
    for toks, ptab, offs, nval in ticks:
        jl, jcache = jstep(jp, jcache, *map(jnp.asarray, (toks, ptab, offs,
                                                          nval)))
        tl, tcache = tm.decode_paged(tp, T(toks), tcache, T(ptab), T(offs),
                                     T(nval))
        live = nval > 0
        worst = max(worst, _rel(tl.numpy()[live], np.asarray(jl)[live]))
        for i in range(2):
            for kv in ("k", "v"):
                worst = max(worst, _rel(
                    tcache["layers"][i][kv].float().numpy()[1:],
                    np.asarray(jcache["layers"][f"l{i}"][kv])[1:]))
    print(f"approx={approx}: decode_paged rel {worst:.2e}")
    assert worst <= rtol


@pytest.mark.parametrize("approx", [False, True])
def test_bf16_prefill_and_greedy_decode_match_reference(approx):
    """The card's configuration, bf16 activations and KV (the projected
    patches cast to bf16 ahead of the bf16 token embeddings), against the
    reference compiled with XLA's excess precision off
    (``_torch_helpers._strict``): prefill and STEPS greedy decode steps,
    logits within BF16_RTOL of their largest magnitude and the tokens
    100% equal."""
    jm, jp, tm, tp = _pair(approx, "bfloat16")
    toks, pat = _inputs(seed=5)
    jl, jc = _strict(jax.jit(lambda p, t, pt: jm.prefill(
        p, {"tokens": t, "patches": pt}, CTX, CACHE_N)))(jp, toks, pat)
    tl, tc = tm.prefill(tp, {"tokens": T(toks), "patches": T(pat)}, CACHE_N)
    assert tc["layers"][0]["k"].dtype == torch.bfloat16
    dec = _strict(jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX)))
    diffs = [_rel(tl, jl)]
    for _ in range(STEPS):
        nt = tl.numpy().argmax(-1).astype(np.int32)
        assert np.array_equal(nt, np.asarray(jl).argmax(-1))
        jl, jc = dec(jp, jnp.asarray(nt), jc)
        tl, tc = tm.decode_step(tp, T(nt), tc)
        diffs.append(_rel(tl, jl))
    print(f"bf16 approx={approx}: rel {[f'{d:.1e}' for d in diffs]}")
    assert max(diffs) <= BF16_RTOL
