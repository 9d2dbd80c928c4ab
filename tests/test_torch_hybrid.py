"""The port's hybrid family (jamba_1_5_large_398b) against the JAX
reference (CPU, plain torch).

Reduced jamba_1_5_large_398b: one superblock of 8 layers (slot 4
attention, the rest Mamba mixers), 4 experts top-2 on every other slot
(``moe_every`` 2: slots 1, 3, 5, 7), d_model 128 (d_inner 256, state 16,
conv 4), with the reference's params carried over by ``load_jax_params``.
The reference arm is the jitted ``jnp`` backend with its weight matmuls
summed one k at a time (``chunk1``: ``qmatmul`` and ``qmatmul_batched``
patched on the test side to ``chunk=1``, the port's K order, as
``tests/test_torch_moe.py`` does for the experts); nothing in
``src/repro`` changes.  Capacity factor 2 in the model cases: 2 x tokens
x top-2 / 4 experts slots an expert, as many as the tokens, so nothing
is dropped (the drop rule is held by ``tests/test_torch_moe.py``).  The
bf16 cases also run the card's configuration, every FFN dense
(``n_experts=0``), with the reference compiled with XLA's excess
precision off (``_torch_helpers._strict``).

Tolerances (measured worst cases in brackets):

* the scan, given the same inputs: bit-equal (the odd/even recursion of
  ``jax.lax.associative_scan`` with the ``b`` update as one fused
  multiply-add), and so are ``aa * h + bb``, the decode update and the
  causal conv (f32: XLA's contraction; bf16: a rounding after every op);
* the Mamba mixer, f32: output, final state and conv state within
  MAMBA_RTOL of their largest magnitude [6.7e-7]: ``x_proj`` /
  ``dt_proj`` and the N = 16 read-out sum in another order, ``exp`` and
  ``log1p`` round differently from XLA's; bf16: within MAMBA_BF16_RTOL
  [4.2e-3, under a bf16 ulp of the largest value];
* each slot, f32, fed the residual stream the reference's slot received:
  within SLOT_RTOL of the largest magnitude of its output, RAPID and
  EXACT [9.0e-7];
* logits, f32, EXACT: atol 1e-5 (EXACT_ATOL) [9.95e-6 forward, 8.9e-6
  prefill and decode: the slots' f32 sums in other orders, relative
  2.5e-6 of a residual stream of ~850 after the MoE slots];
* logits, f32, RAPID: atol 6e-2 (RAPID_ATOL) [5.0e-2 forward, 1.1e-2
  prefill, 4.7e-3 the second decode step], looser than the dense
  family's 2.3e-3.  Chained, the port's stream drifts from 9e-7 after
  slot 0 to 5.9e-3 of its largest magnitude after slot 1: a one-ulp
  input difference moves an in_proj / out_proj operand across an edge
  of its RAPID coefficient cell (1.1e-3 in one token's ln2 output), and
  the MoE FFN carries that token's 2e-4 to 3.1 of ~520; it ends at
  7.1e-3 after slot 7 (``test_slots_match_reference_on_its_inputs``
  prints the drift slot by slot);
* logits, bf16, every FFN dense, RAPID and EXACT: atol 2^-5 (BF16_ATOL,
  one bf16 ulp at the logits' largest magnitude, 4.4) [1.6e-2 RAPID
  forward, 0 elsewhere; on eight torch threads 4.9e-4 EXACT forward and
  0 elsewhere]: the f32 sums above, rounded to bf16, now and then fall
  the other way;
* greedy tokens: 100% equal to the reference's ``ServeEngine`` (f32 with
  the MoE slots on, bf16 dense), the left-padded rows included (the pads
  enter the recurrence in both).
"""
from functools import lru_cache, partial
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import _strict, assert_same_bits  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import P as JP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs.base import EXACT as TEXACT  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import (load_jax_params,  # noqa: E402
                                       tree_items, tree_map)
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousServeEngine  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
ARCH = "jamba_1_5_large_398b"
LOCK = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
CACHE_N = 32
MAMBA_RTOL = 2e-6
MAMBA_BF16_RTOL = 2.0 ** -6
EXACT_ATOL = 1e-5
RAPID_ATOL = 6e-2
SLOT_RTOL = 2e-6
BF16_ATOL = 2.0 ** -5


@pytest.fixture(scope="module", autouse=True)
def chunk1():
    """The reference's weight matmuls summed one k at a time (the port's
    order) for the whole module: its jitted functions trace inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "qmatmul", partial(jops.qmatmul, chunk=1))
        mp.setattr(jmoe, "qmatmul_batched",
                   partial(jops.qmatmul_batched, chunk=1))
        yield


def _cfgs(approx, dtype="float32", scan_layers=False, dense=False):
    over = dict(dtype=dtype, capacity_factor=2.0)
    if dense:
        over["n_experts"] = 0
    jc = jget(ARCH).reduced().with_(scan_layers=scan_layers, **over)
    tc = tget(ARCH).reduced().with_(**over)
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    return jc.with_backend("jnp"), tc


@lru_cache(maxsize=None)
def _init_tree(scan_layers):
    """The reference's seeded init of reduced jamba, as numpy, with each
    Mamba slot's a_log and conv_b drawn away from their zeros (so the
    decay rates and the conv bias reach the outputs); ``blocks`` keyed
    ``l0``, or stacked as ``scan_layers=True`` lays it out (one
    superblock: a leading dim of 1)."""
    jc = jget(ARCH).reduced()
    tree = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def walk(t):
        if isinstance(t, dict):
            if "a_log" in t:
                return dict(t, a_log=(0.5 * rng.standard_normal(
                    t["a_log"].shape)).astype(np.float32),
                    conv_b=(0.1 * rng.standard_normal(
                        t["conv_b"].shape)).astype(np.float32))
            return {k: walk(v) for k, v in t.items()}
        return t
    block = walk(tree["blocks"]["l0"])
    blocks = (tree_map(lambda a: a[None], block) if scan_layers
              else {"l0": block})
    return dict(tree, blocks=blocks)


@lru_cache(maxsize=None)
def _dense_tree():
    """``_init_tree(False)`` with every MoE slot's FFN replaced by a dense
    one, its expert 0 (``n_experts=0``)."""
    tree = _init_tree(False)
    block = {name: (dict(slot, ffn={w: slot["ffn"][w][0]
                                    for w in ("w1", "w3", "w2")})
                    if "router" in slot["ffn"] else slot)
             for name, slot in tree["blocks"]["l0"].items()}
    return dict(tree, blocks={"l0": block})


def _pair(approx, dtype="float32", dense=False):
    jc, tc = _cfgs(approx, dtype, dense=dense)
    tree = _dense_tree() if dense else _init_tree(False)
    return (JModel(jc), jax.tree.map(jnp.asarray, tree), TModel(tc),
            load_jax_params(tree, device="cpu"))


def _padded(prompts):
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p  # left-pad, as the engines
    return toks


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------------------
# config and params
# --------------------------------------------------------------------------

def test_reduced_jamba_keeps_one_period():
    """One full superblock, as the reference's ``reduced()``: slot 4 is
    attention, the odd slots carry the experts."""
    cfg = tget(ARCH).reduced()
    assert (cfg.n_layers, cfg.attn_every, cfg.moe_every) == (8, 8, 2)
    assert thybrid.attn_slot(cfg) == 4
    assert [thybrid._slot_is_moe(cfg, s) for s in range(8)] == [
        False, True] * 4
    assert not thybrid._slot_is_moe(cfg.with_(n_experts=0), 1)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_load_jax_params_carries_superblocks(scan_layers):
    """The reference's tree, stacked or ``l{i}`` (its shapes those of the
    reference's spec tree for that layout), arrives leaf for leaf in the
    port's own spec tree: superblocks of ``slot{s}`` subtrees."""
    tree = _init_tree(scan_layers)
    ref_specs = JModel(_cfgs(False, scan_layers=scan_layers)[0]).param_specs()
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda p: tuple(p.shape), ref_specs, is_leaf=lambda x: isinstance(
            x, JP))
    tp = load_jax_params(tree, device="cpu")
    tm = TModel(_cfgs(False)[1])

    def paths(t, pre=()):
        if isinstance(t, dict):
            return {q for k, v in t.items() for q in paths(v, pre + (k,))}
        if isinstance(t, list):
            return {q for i, v in enumerate(t) for q in paths(v, pre + (i,))}
        return {pre}
    assert paths(tp) == paths(tm.param_specs())
    assert len(tp["blocks"]) == 1
    blocks = tree["blocks"]
    want = dict(tree, blocks=[
        jax.tree.map(lambda a: a[0], blocks) if scan_layers
        else blocks["l0"]])
    for path, got in tree_items(tp):
        leaf = want
        for key in path:
            leaf = leaf[key]
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=str(path))


# --------------------------------------------------------------------------
# the Mamba mixer's parts: bits where XLA's contraction is matched
# --------------------------------------------------------------------------

def test_fma_rounds_once():
    """``fma`` against exact rational arithmetic: a * b + c rounded once
    to float32, on random operands, cancellations and ties."""
    rng = np.random.default_rng(0)
    n = 400
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.uniform(-1e-6, 1e-6, n))
         ).astype(np.float32)  # near-cancellations
    c[: n // 2] = rng.standard_normal(n // 2).astype(np.float32)
    c[:8] = 0.0
    got = tmamba.fma(T(a), T(b), T(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # float() rounds once, to f64
        # the f32 value nearest to the exact one, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        err = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(err)
        want = [v for v, e in zip(cands, err) if e == best]
        if len(want) > 1:
            want = [v for v in want if not (v.view(np.int32) & 1)]
        assert got[i].view(np.int32) == want[0].view(np.int32), i


@pytest.mark.parametrize("C", [32, 3, 7])
def test_chunk_scan_state_bits(C):
    """The prefill chunk's scan and ``aa * h + bb`` against
    ``jax.lax.associative_scan`` with the reference's operator on the same
    inputs (a full chunk, and the odd lengths of a short prompt): the same
    bits."""
    rng = np.random.default_rng(C)
    B, di, N = 2, 64, 16
    da = np.exp(-rng.uniform(0, 2, (B, C, di, N))).astype(np.float32)
    dbx = rng.standard_normal((B, C, di, N)).astype(np.float32)
    h = rng.standard_normal((B, di, N)).astype(np.float32)

    def ref(da, dbx, h):
        def op(e1, e2):
            a1, b1 = e1
            a2, b2 = e2
            return a1 * a2, b1 * a2 + b2
        aa, bb = jax.lax.associative_scan(op, (da, dbx), axis=1)
        return aa, bb, aa * h[:, None] + bb

    want = [np.asarray(t) for t in jax.jit(ref)(da, dbx, h)]
    aa, bb = tmamba.chunk_scan(T(da), T(dbx))
    hs = tmamba.fma(aa, T(h)[:, None].expand_as(aa), bb)
    for got, w in zip((aa, bb, hs), want):
        assert_same_bits(got.numpy(), w)


def test_decode_update_and_conv_bits():
    """The decode step's ``dA * h + (dt x) B`` and the reference's
    ``_conv_causal`` (f32 and bf16, with and without a carried state) on
    the same inputs: the same bits."""
    rng = np.random.default_rng(1)
    B, di, N, S, K = 3, 64, 16, 9, 4
    dA = np.exp(-rng.uniform(0, 2, (B, di, N))).astype(np.float32)
    h = rng.standard_normal((B, di, N)).astype(np.float32)
    dtx = rng.standard_normal((B, di)).astype(np.float32)
    Bm = rng.standard_normal((B, N)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, h, u, b: a * h + u[..., None]
                              * b[:, None, :])(dA, h, dtx, Bm))
    got = tmamba.fma(T(dA), T(h), T(dtx)[..., None] * T(Bm)[:, None, :])
    assert_same_bits(got.numpy(), want)

    x = rng.standard_normal((B, S, di)).astype(np.float32)
    w = (0.5 * rng.standard_normal((K, di))).astype(np.float32)
    b = (0.1 * rng.standard_normal(di)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, di)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        for state in (None, st):
            args = [jnp.asarray(t, jdt) for t in (x, w, b)]
            targs = [T(t).to(tdt) for t in (x, w, b)]
            if state is None:
                out, cs = jax.jit(jmamba._conv_causal)(*args)
                tout, tcs = tmamba._conv_causal(*targs)
            else:
                out, cs = jax.jit(jmamba._conv_causal)(
                    *args, jnp.asarray(st, jdt))
                tout, tcs = tmamba._conv_causal(*targs, T(st).to(tdt))
            for g, r in ((tout, out), (tcs, cs)):
                assert_same_bits(g.float().numpy(),
                                 np.asarray(r.astype(jnp.float32)))


# --------------------------------------------------------------------------
# the Mamba mixer against the reference
# --------------------------------------------------------------------------

def _mamba_slot(approx):
    jc, tc = _cfgs(approx)
    tree = _init_tree(False)["blocks"]["l0"]["slot0"]["mamba"]
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            load_jax_params(tree, device="cpu"))


@pytest.mark.parametrize("S,approx", [(3, False), (2, True), (32, False),
                                      (40, True), (70, False), (70, True)])
def test_mamba_and_decode_match_reference(S, approx):
    """The prefill form on 2 x S tokens (S < K - 1 and S = K - 1: the
    conv state holds zero pads; 40 and 70: padding to a whole chunk and
    the state carried across chunks): the output and the final (h, conv)
    within MAMBA_RTOL of their largest magnitude; then three decode steps
    chained on each side's own state, the cache written in place."""
    jc, jp, tc, tp = _mamba_slot(approx)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    out, (h, cs) = jax.jit(lambda x, p: jmamba.mamba(x, p, jc, CTX))(x, jp)
    tout, (th, tcs) = tmamba.mamba(T(x), tp, tc)
    rel = [_rel(tout, out), _rel(th, h), _rel(tcs, cs)]
    print(f"S={S} approx={approx}: prefill out / h / conv rel {rel}")
    assert tout.shape == out.shape and th.dtype == torch.float32
    assert max(rel) <= MAMBA_RTOL
    cache = {"h": th, "conv": tcs}
    addr = (th.data_ptr(), tcs.data_ptr())
    step = jax.jit(lambda x, c, p: jmamba.mamba_decode(x, c, p, jc, CTX))
    for i in range(3):
        xd = rng.standard_normal((2, 128)).astype(np.float32)
        out, (h, cs) = step(xd, (h, cs), jp)
        tout, cache = tmamba.mamba_decode(T(xd), cache, tp, tc)
        rel = [_rel(tout, out), _rel(cache["h"], h),
               _rel(cache["conv"], cs)]
        print(f"  decode {i}: out / h / conv rel {rel}")
        assert max(rel) <= MAMBA_RTOL
        assert (cache["h"].data_ptr(), cache["conv"].data_ptr()) == addr


@pytest.mark.parametrize("approx", [True, False])
def test_mamba_bf16_matches_reference(approx):
    """The mixer at the serve path's dtype, bfloat16, on 2 x 40 tokens:
    the output, the final state and the conv state within
    MAMBA_BF16_RTOL of their largest magnitude: single bf16 ulps of
    difference in ``in_proj``'s output (summed in another order) enter
    the conv, the state and the output."""
    jc, jp, tc, tp = _mamba_slot(approx)
    jc, tc = jc.with_(dtype="bfloat16"), tc.with_(dtype="bfloat16")
    x = np.random.default_rng(5).standard_normal((2, 40, 128))
    xb = T(x.astype(np.float32)).to(torch.bfloat16)
    out, (h, cs) = jax.jit(lambda x, p: jmamba.mamba(x, p, jc, CTX))(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jp)
    tout, (th, tcs) = tmamba.mamba(xb, tp, tc)
    assert tout.dtype == torch.bfloat16 and tcs.dtype == torch.bfloat16
    rel = [_rel(tout.float(), out.astype(jnp.float32)), _rel(th, h),
           _rel(tcs.float(), cs.astype(jnp.float32))]
    print(f"bf16 approx={approx}: out / h / conv rel {rel}")
    assert max(rel) <= MAMBA_BF16_RTOL


# --------------------------------------------------------------------------
# the model and the engine
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _reference_run(approx, dtype, dense):
    """The reference (compiled by :func:`_strict`) on LOCK, as numpy: its
    forward logits, the residual stream entering each of its 8 slots and
    its final norm (recorded by a ``jax.debug.callback`` on the input of
    every ln1 and of the final norm), prefill + 2 decode steps' logits
    (its engine's compiled steps) and its ``ServeEngine``'s greedy
    tokens."""
    jm, jp, _, _ = _pair(approx, dtype, dense)
    toks = jnp.asarray(_padded(LOCK))
    seen = []

    def record(norm):
        def wrapped(x, *args, **kw):
            jax.debug.callback(lambda v: seen.append(np.array(v)), x,
                               ordered=True)
            return norm(x, *args, **kw)
        return wrapped
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhybrid, "apply_norm", record(jhybrid.apply_norm))
        mp.setattr(jmodel, "apply_norm", record(jmodel.apply_norm))
        fwd = _strict(jax.jit(lambda p, t: jm.forward(p, {"tokens": t},
                                                      CTX)))(jp, toks)
        fwd = np.asarray(fwd, np.float32)
    streams = seen[::2]  # ln1's inputs (ln2's between them), then the last
    assert len(seen) == 17 and len(streams) == 9
    jeng = JEngine(jm, jp, CTX, cache_n=CACHE_N)
    jeng._prefill, jeng._decode = _strict(jeng._prefill), _strict(
        jeng._decode)
    jl, jc = jeng._prefill(jp, {"tokens": toks})
    steps = [np.asarray(jl, np.float32)]
    for _ in range(2):
        nt = jnp.asarray(np.asarray(jl).argmax(-1).astype(np.int32))
        jl, jc = jeng._decode(jp, nt, jc)
        steps.append(np.asarray(jl, np.float32))
    return fwd, streams, steps, jeng.generate(LOCK, max_new=4)


def _check_model(approx, dtype, dense, near):
    """``forward``, ``prefill`` and two chained ``decode_step`` logits
    against the reference's (``near(got, want)``), the greedy choices
    equal, then the lockstep engine's greedy tokens 100% equal to the
    reference's ``ServeEngine`` on three left-padded prompts, one trace
    each."""
    fwd, _, steps, ref_tokens = _reference_run(approx, dtype, dense)
    _, _, tm, tp = _pair(approx, dtype, dense)
    toks = T(_padded(LOCK))
    got = tm.forward(tp, {"tokens": toks}).float().numpy()
    print(f"approx={approx} {dtype}: forward max |diff| "
          f"{np.abs(got - fwd).max():.3e}")
    near(got, fwd)
    tl, tc = tm.prefill(tp, {"tokens": toks}, CACHE_N)
    for i, want in enumerate(steps):
        got = tl.float().numpy()
        print(f"  step {i}: max |diff| {np.abs(got - want).max():.3e}")
        near(got, want)
        nt = want.argmax(-1).astype(np.int32)
        assert np.array_equal(got.argmax(-1), nt)
        if i < len(steps) - 1:
            tl, tc = tm.decode_step(tp, T(nt), tc)
    eng = TEngine(tm, tp, cache_n=CACHE_N)
    assert eng.generate(LOCK, max_new=4) == ref_tokens
    assert eng.trace_counts == {"decode": 1, "prefill": 1}


@pytest.mark.parametrize("approx", [True, False])
def test_logits_and_greedy_tokens_match_reference(approx):
    """f32 with the MoE slots on: logits within RAPID_ATOL / EXACT_ATOL,
    greedy tokens 100% equal (:func:`_check_model`)."""
    atol = RAPID_ATOL if approx else EXACT_ATOL
    _check_model(approx, "float32", False, partial(
        np.testing.assert_allclose, atol=atol, rtol=0))


@pytest.mark.parametrize("approx", [True, False])
def test_slots_match_reference_on_its_inputs(approx):
    """Each slot of the port fed the residual stream the reference's
    slot received, over the whole sequence (f32, MoE slots on): its
    output within SLOT_RTOL of the largest magnitude of the reference
    slot's output.  The port's own chain is printed beside it: how far
    the stream has drifted by each slot."""
    _, streams, _, _ = _reference_run(approx, "float32", False)
    _, _, tm, tp = _pair(approx)
    pos = torch.arange(streams[0].shape[1], dtype=torch.int32)
    own = T(streams[0])
    for s in range(8):
        slot = tp["blocks"][0][f"slot{s}"]
        got, _ = thybrid._slot_apply(T(streams[s]), slot, s, tm.cfg, pos)
        own, _ = thybrid._slot_apply(own, slot, s, tm.cfg, pos)
        rel, drift = _rel(got, streams[s + 1]), _rel(own, streams[s + 1])
        print(f"approx={approx} slot {s}: on the reference's input "
              f"{rel:.2e}, chained {drift:.2e} of "
              f"{np.abs(streams[s + 1]).max():.1f}")
        assert rel <= SLOT_RTOL, s


@pytest.mark.parametrize("approx", [True, False])
def test_bf16_dense_matches_reference(approx):
    """The card's configuration: bfloat16 activations and caches, every
    FFN dense (``n_experts=0``), against the reference compiled with
    XLA's excess precision off: forward, prefill and decode logits
    within BF16_ATOL, greedy tokens 100% equal."""
    _check_model(approx, "bfloat16", True, partial(
        np.testing.assert_allclose, atol=BF16_ATOL, rtol=0))


def test_decode_cache_holds_the_mamba_state():
    """The engine's persistent decode cache receives every leaf of
    prefill's cache: each Mamba slot's h and conv as well as the
    attention slot's k / v."""
    _, _, tm, tp = _pair(False)
    eng = TEngine(tm, tp, cache_n=CACHE_N)
    _, cache = tm.prefill(tp, {"tokens": T(_padded(LOCK))}, CACHE_N)
    static = eng._decode_cache(cache)
    assert static is not cache
    for s in range(8):
        for key in (("k", "v") if s == 4 else ("h", "conv")):
            src = cache["layers"][0][f"slot{s}"][key]
            dst = static["layers"][0][f"slot{s}"][key]
            assert dst.data_ptr() != src.data_ptr() and src.abs().max() > 0
            assert torch.equal(dst, src), (s, key)
    assert eng._decode_cache(cache) is static


def test_paged_routes_refuse_the_hybrid():
    """The continuous engine, ``decode_paged`` and the paged cache raise
    ``ValueError`` for the hybrid family, as the reference's."""
    _, _, tm, tp = _pair(False)
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousServeEngine(tm, tp)
    with pytest.raises(ValueError, match="recurrent state"):
        tm.init_paged_cache(4, 8, "cpu")
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="recurrent state"):
        tm.decode_paged(tp, z, {}, z, z[0], z[0] + 1)


def test_launcher_serves_jamba_lockstep(capsys):
    """``launch/serve.py`` serves reduced jamba on the CPU through the
    lockstep engine; ``--continuous`` raises."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--batch", "2", "--max-new", "3", "--cache", "16"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "6 tokens" in out and out.count("req") == 2
    assert "{'decode': 1, 'prefill': 1}" in out
    with pytest.raises(ValueError, match="dense/moe"):
        serve.main(argv + ["--continuous"])


# --------------------------------------------------------------------------
# the blocks' moe_layer argument
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm_2b", "qwen3_moe_235b_a22b"])
def test_block_moe_layer_keeps_the_families_bits(arch):
    """``moe_layer`` picks the FFN as ``cfg.n_experts`` did before it
    (the model passes ``cfg.n_experts > 0``): a dense and an MoE block's
    full-sequence pass and decode step equal their composition from the
    public layers, the MoE output plus the residual after it and the
    dense MLP with the residual in w2's epilogue (the full-sequence pass
    bit for bit, RAPID; the decode step, EXACT, within 1e-5, its one-token
    attention written as the cached v)."""
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import apply_norm, attention, dense, mlp
    from repro_torch.models.moe import moe_ffn
    cfg = tget(arch).reduced().with_(dtype="float32", approx=TRAPID,
                                     capacity_factor=8.0)
    moe = cfg.n_experts > 0
    tm = TModel(cfg)
    p = tm.init(0, "cpu")["blocks"][0]
    assert ("router" in p["ffn"]) == moe
    assert set(tt.block_params(cfg)["ffn"]) == set(p["ffn"])
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(6, dtype=torch.int32)
    got, (k, v) = tt.block_apply(x, p, cfg, pos)
    (y, ydiv), k2, v2 = attention(apply_norm(x, p["ln1"], cfg), p["attn"],
                                  cfg, pos, residual=x, tail_norm=True)
    ffn_in = ydiv * p["ln2"]["scale"]
    want = (y + moe_ffn(ffn_in, p["ffn"], cfg) if moe
            else mlp(ffn_in, p["ffn"], cfg, residual=y))
    assert torch.equal(got, want) and torch.equal(k, k2)
    # the decode step (EXACT: one cached token's softmax weight is 1
    # exactly): the residual rides wo's epilogue, then the FFN
    cfg = cfg.with_(approx=TEXACT)
    cache = tm.init_cache(2, 8, "cpu")
    slots, pos0 = cache["slots"], torch.zeros((), dtype=torch.int32)
    slots[:, 0] = 0
    x0 = x[:, 0]
    got, _ = tt.block_decode(x0, p, cache["layers"][0], slots, pos0, cfg,
                             moe)
    h = apply_norm(x0[:, None], p["ln1"], cfg)
    v = dense(h, p["attn"]["wv"], cfg.approx, "attn_proj")
    G = cfg.n_heads // cfg.n_kv_heads
    # one cached token: attention returns its v, repeated over the group
    att = v.reshape(2, cfg.n_kv_heads, 1, cfg.hd).expand(
        -1, -1, G, -1).reshape(2, 1, -1)
    y = dense(att, p["attn"]["wo"], cfg.approx, "attn_proj",
              residual=x0[:, None])
    h2 = apply_norm(y, p["ln2"], cfg)
    want = (y + moe_ffn(h2, p["ffn"], cfg) if moe
            else mlp(h2, p["ffn"], cfg, residual=y))[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
