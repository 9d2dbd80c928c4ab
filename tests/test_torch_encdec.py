"""The port's encdec family (whisper_medium) against the JAX reference
(CPU, plain torch).

Reduced whisper_medium: 2 encoder + 2 decoder layers, d_model 128, 4
heads of 32, ``frontend_seq`` 8, vocab 512, LN (its scales and biases
drawn away from ones and zeros, so both reach the logits) and the
ungated gelu MLP, with the reference's params carried over by
``load_jax_params``.  Inputs: ``enc_embeds`` [B, frames, 1024] (x 0.1,
as the reference's tests scale them) and prompts from a numpy seed.  The
reference arm is the jitted ``jnp`` backend with its weight matmuls
summed one k at a time (``chunk1``: ``qmatmul`` patched on the test side
to ``chunk=1``, the port's K order, as ``tests/test_torch_hybrid.py``
does); nothing in ``src/repro`` changes.

Tolerances (measured worst cases in brackets):

* the cross k/v, the projections of the encoder's output, on the same
  input: bit-equal (the reference's recomputed ``ck`` / ``cv`` under
  RAPID, the port's own product under both);
* one cross-attention, encoder block or decoder block fed the same
  inputs as the reference's, f32: within RTOL 5e-6 of the largest
  magnitude of each output [cross-attention 1.1e-7; blocks 3.5e-7, k /
  v included]: the RAPID products are bit-equal on equal operands, and
  the exact score / value einsums and the LN and softmax row sums
  (ROADMAP rule 3: <= 2 and <= 3 ulp) sum in other orders than XLA's;
* the encoder from the same frame embeddings: EXACT within RTOL
  [1.1e-6 at 8 frames, 8.9e-7 at 1100]; RAPID within RTOL at 8 frames
  [4.9e-6] and within ENC_RAPID_RTOL 5e-2 at 1100 [1.25e-2].  The score
  and value einsums differ from XLA's by a few ulp, and a RAPID product
  or quotient jumps by up to a few percent when an operand that far off
  crosses into the next coefficient cell: rare over 8 frames, common
  over 1100.  One RAPID attention core over 1100 frames on the
  reference's own q / k / v holds that apart: scores within RTOL
  [2.1e-7]; the softmax divide the same bits once fed the reference's
  row sums and within SOFTMAX_1100_ULP 8 end to end [5 ulp]; every
  probability row past RTOL one whose inputs differ [0.23% of rows];
  the core within ATTN_1100_RTOL 1e-3 [2.4e-4] with at most
  ATTN_1100_SHARE 1% of its outputs past RTOL [0.13%].  Where the
  reference pads the last q chunk (1100 = 1024 + 76 rows) the port's
  padding-free chunk is held bit for bit instead;
* logits, f32: EXACT within atol 1e-4 (EXACT_ATOL) [3.1e-6]; RAPID
  within atol 5e-2 (RAPID_ATOL) [4.8e-4 forward, 1.5e-2 at the sixth
  decode step] of logits of ~4.5, not 1e-2: the cell crossings above,
  which the cross k/v carry into every decode step;
* one decoder block at bf16 (RAPID and EXACT), against the reference
  compiled with XLA's excess precision off (``_torch_helpers._strict``):
  within BF16_RTOL 2^-6 of the output's largest magnitude [0: the same
  bits];
* greedy tokens: 100% equal over 8 decode steps, EXACT and RAPID.
"""
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (_strict, assert_same_bits,  # noqa: E402
                            perturb_ln, ulp_diff)
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.kernels.fused_div import ref as jfd  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params, tree_items  # noqa: E402
from repro_torch.serve.compiled import CompiledStep  # noqa: E402
from repro_torch.serve.scheduler import ContinuousServeEngine  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
ARCH = "whisper_medium"
B, S, CACHE_N, STEPS = 2, 7, 16, 8
RTOL = 5e-6
ENC_RAPID_RTOL = 5e-2
SOFTMAX_1100_ULP = 8
ATTN_1100_RTOL = 1e-3
ATTN_1100_SHARE = 1e-2
EXACT_ATOL = 1e-4
RAPID_ATOL = 5e-2
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
    """The reference's seeded init as numpy, LN scales and biases drawn
    from a seed."""
    jc = _cfgs(False, **over)[0]
    return perturb_ln(jax.tree.map(np.asarray,
                                   JModel(jc).init(jax.random.PRNGKey(0))))


def _pair(approx, dtype="float32", **over):
    jc, tc = _cfgs(approx, dtype, **over)
    tree = _tree(**over)
    return (JModel(jc), jax.tree.map(jnp.asarray, tree), TModel(tc),
            load_jax_params(tree, device="cpu"))


def _inputs(frames=8, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (batch, S)).astype(np.int32)
    emb = (0.1 * rng.standard_normal((batch, frames, 1024))).astype(
        np.float32)
    return toks, emb


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------------------
# config, params, cache layout
# --------------------------------------------------------------------------

def test_config_and_reduced_match_reference():
    """whisper_medium field for field (24 + 24 layers, 1024 wide, 16 / 16
    heads of 64, d_ff 4096, vocab 51865, gelu, LN, 1500 frames),
    and ``reduced()`` clamping the encoder to 2 layers of 8 frames, as
    the reference's."""
    for full, ref in ((tget(ARCH), jget(ARCH)),
                      (tget(ARCH).reduced(), jget(ARCH).reduced())):
        for f in ("family", "n_layers", "n_encoder_layers", "d_model",
                  "n_heads", "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "act", "norm", "frontend_seq"):
            assert getattr(full, f) == getattr(ref, f), f
    red = tget(ARCH).reduced()
    assert (red.n_encoder_layers, red.frontend_seq, red.n_layers) == (2, 8, 2)
    assert (tget(ARCH).n_encoder_layers, tget(ARCH).frontend_seq) == (24, 1500)


def test_full_param_specs_match_reference_shapes():
    """``Model(whisper_medium).param_specs()`` against the reference's
    ``param_shapes()`` (its stacked layers unstacked) path for path and
    shape for shape: 813 907 968 params, nothing allocated."""
    specs = TModel(tget(ARCH)).param_specs()
    got = {p: tuple(s.shape) for p, s in tree_items(specs)}
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            JModel(jget(ARCH)).param_shapes())[0]:
        keys = tuple(k.key for k in path)
        if keys[0] in ("blocks", "enc_blocks"):
            for i in range(leaf.shape[0]):
                ref[(keys[0], i) + keys[1:]] = tuple(leaf.shape[1:])
        else:
            ref[keys] = tuple(leaf.shape)
    assert got == ref
    assert sum(int(np.prod(s)) for s in got.values()) == 813_907_968
    assert sorted(specs["blocks"][0]) == ["attn", "ffn", "ln1", "ln2", "lnx",
                                          "xattn"]
    assert sorted(specs["enc_blocks"][0]) == ["attn", "ffn", "ln1", "ln2"]


@pytest.mark.parametrize("scan_layers", [False, True])
def test_load_jax_params_carries_the_encdec_tree(scan_layers):
    """The reference's tree, keyed ``l{i}`` or stacked, arrives leaf for
    leaf in the port's own spec tree: ``adapter``, ``enc_pos``,
    ``enc_final_norm``, ``enc_blocks`` and the decoder's ``lnx`` /
    ``xattn`` included, the reference's values in each."""
    jc = _cfgs(False, scan_layers=scan_layers)[0]
    tree = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(1)))
    tp = load_jax_params(tree, device="cpu")
    specs = TModel(_cfgs(False)[1]).param_specs()
    assert [p for p, _ in tree_items(tp)] == [p for p, _ in tree_items(
        specs)]
    want = dict(tree)
    for key, n in (("blocks", 2), ("enc_blocks", 2)):
        want[key] = [jax.tree.map(lambda a, i=i: a[i], tree[key])
                     if scan_layers else tree[key][f"l{i}"]
                     for i in range(n)]
    for path, got in tree_items(tp):
        leaf = want
        for key in path:
            leaf = leaf[key]
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=str(path))
    assert tuple(tp["adapter"].shape) == (1024, 128)
    assert tuple(tp["enc_pos"].shape) == (8, 128)


def test_init_cache_matches_reference_layout():
    """The cache tree has the reference's keys and no other: ``pos``,
    ``slots`` and per layer ``k`` / ``v`` (the ring) and ``ck`` / ``cv``
    (every frame), in the config's dtype, zero."""
    jm = JModel(jget(ARCH).reduced())
    ref = jm.init_cache(3, 24)
    cache = TModel(tget(ARCH).reduced()).init_cache(3, 24, "cpu")
    assert sorted(cache) == sorted(ref) == ["layers", "pos", "slots"]
    np.testing.assert_array_equal(cache["slots"].numpy(),
                                  np.asarray(ref["slots"]))
    assert len(cache["layers"]) == len(ref["layers"]) == 2
    for lc in cache["layers"]:
        assert sorted(lc) == sorted(ref["layers"]["l0"]) == ["ck", "cv", "k",
                                                            "v"]
        for k, t in lc.items():
            assert tuple(t.shape) == ref["layers"]["l0"][k].shape, k
            assert t.dtype == torch.bfloat16 and not t.any()
    assert tuple(cache["layers"][0]["ck"].shape) == (3, 8, 4, 32)


def test_paged_routes_and_engines_refuse_encdec():
    """``decode_paged``, the paged cache and the continuous engine raise
    ``ValueError`` for the encdec family, as the reference's."""
    _, _, tm, tp = _pair(False)
    with pytest.raises(ValueError, match="cross state"):
        tm.init_paged_cache(4, 8, "cpu")
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="cross state"):
        tm.decode_paged(tp, z, {}, z, z[0], z[0] + 1)
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousServeEngine(tm, tp)


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_launcher_refuses_frontend_families(family):
    """``launch/serve.py`` refuses encdec (whisper_medium by name) and vlm
    with the reference launcher's message: the engines build token-only
    batches."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="pure-text archs"):
        serve.check_servable(tget(ARCH).with_(family=family))
    if family == "encdec":
        with pytest.raises(ValueError, match="pure-text archs"):
            serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


# --------------------------------------------------------------------------
# the parts against the reference on the same inputs
# --------------------------------------------------------------------------

def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("approx", [False, True])
def test_cross_attention_on_reference_inputs(approx):
    """One cross-attention (``attention(kv_x=...)``: q from the stream, k
    / v from the encoder's output, no rope, no mask; the residual in
    wo's epilogue) on the same inputs as the reference's: k / v
    bit-equal under RAPID, the output within RTOL of its largest
    magnitude."""
    jc, tc = _cfgs(approx)
    p = _tree()["blocks"]["l0"]["xattn"]
    rng = np.random.default_rng(3)
    x, enc = _rand(rng, B, S, 128), _rand(rng, B, 8, 128)
    pos, fpos = np.arange(S, dtype=np.int32), np.arange(8, dtype=np.int32)
    out, k, v = jax.jit(lambda x, e, p: jlayers.attention(
        x, p, jc, CTX, jnp.asarray(pos), kv_x=e,
        kv_positions=jnp.asarray(fpos), causal=False, residual=x))(
        x, enc, jax.tree.map(jnp.asarray, p))
    tout, tk, tv = tlayers.attention(
        T(x), load_jax_params(p, device="cpu"), tc, T(pos), residual=T(x),
        kv_x=T(enc), kv_positions=T(fpos), causal=False)
    assert tuple(tk.shape) == (B, 8, 4, 32)
    if approx:
        assert_same_bits(tk.numpy(), np.asarray(k))
        assert_same_bits(tv.numpy(), np.asarray(v))
    rel = _rel(tout, out)
    print(f"approx={approx}: cross-attention rel {rel:.2e}")
    assert rel <= RTOL


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_blocks_on_reference_inputs(kind, approx):
    """One encoder block (bidirectional self-attention, rope on the
    frames' positions) and one decoder block (causal self-attention, the
    cross slot between it and ln2) on the reference's inputs: output
    within RTOL; the decoder block's self and cross k / v too."""
    jc, tc = _cfgs(approx)
    tree = _tree()
    rng = np.random.default_rng(4)
    enc = _rand(rng, B, 8, 128)
    fpos = np.arange(8, dtype=np.int32)
    if kind == "encoder":
        lp, x, pos, kw = tree["enc_blocks"]["l1"], enc, fpos, {}
        tkw = {"causal": False}
        jkw = {"causal": False}
    else:
        lp, x = tree["blocks"]["l1"], _rand(rng, B, S, 128)
        pos = np.arange(S, dtype=np.int32)
        jkw = {"enc_out": jnp.asarray(enc), "enc_positions": jnp.asarray(
            fpos)}
        tkw = {"enc_out": T(enc), "enc_positions": T(fpos)}
    out, kv = jax.jit(lambda x, lp: jtr.block_apply(
        x, lp, jc, CTX, jnp.asarray(pos), norm_kind="ln", return_kv=True,
        **jkw))(x, jax.tree.map(jnp.asarray, lp))
    tout, tkv = ttr.block_apply(T(x), load_jax_params(lp, device="cpu"), tc,
                                T(pos), **tkw)
    rel = [_rel(tout, out)] + [_rel(a, b) for a, b in zip(tkv, kv)]
    print(f"{kind} approx={approx}: out / k / v rel {rel}")
    assert len(tkv) == (4 if kind == "decoder" else 2)
    assert max(rel) <= RTOL


@pytest.mark.parametrize("approx", [False, True])
def test_decoder_block_bf16(approx):
    """One decoder block at bf16, the card's configuration, against the
    reference compiled with XLA's excess precision off: within
    BF16_RTOL of the output's largest magnitude."""
    jc, tc = _cfgs(approx, "bfloat16")
    lp = _tree()["blocks"]["l0"]
    rng = np.random.default_rng(5)
    x = _rand(rng, B, S, 128).astype(jnp.bfloat16)
    enc = _rand(rng, B, 8, 128).astype(jnp.bfloat16)
    pos, fpos = np.arange(S, dtype=np.int32), np.arange(8, dtype=np.int32)
    out = _strict(jax.jit(lambda x, e, lp: jtr.block_apply(
        x, lp, jc, CTX, jnp.asarray(pos), norm_kind="ln", enc_out=e,
        enc_positions=jnp.asarray(fpos))[0]))(
        x, enc, jax.tree.map(jnp.asarray, lp))
    tx = T(np.asarray(x, np.float32)).to(torch.bfloat16)
    te = T(np.asarray(enc, np.float32)).to(torch.bfloat16)
    tout = ttr.block_apply(tx, load_jax_params(lp, device="cpu"), tc, T(pos),
                           enc_out=te, enc_positions=T(fpos))[0]
    assert tout.dtype == torch.bfloat16
    rel = _rel(tout.float(), np.asarray(out, np.float32))
    print(f"bf16 approx={approx}: rel {rel:.2e}")
    assert rel <= BF16_RTOL


@pytest.mark.parametrize("frames,approx", [(8, False), (8, True),
                                           (1100, False), (1100, True)])
def test_encoder_matches_reference(frames, approx):
    """``_encode`` (the exact f32 adapter product plus ``enc_pos``, the
    bidirectional blocks, ``enc_final_norm``) against the reference's,
    from the same frame embeddings: EXACT within RTOL, RAPID within
    ENC_RAPID_RTOL, at 8 frames and at 1100 (one encoder layer: the
    attention runs a q chunk of 1024 rows and a tail of 76, which the
    reference pads to a whole chunk at position 0; one request: the plain
    K1 runs ~1e7 products a second on one CPU thread)."""
    over = {} if frames == 8 else dict(frontend_seq=frames,
                                       n_encoder_layers=1)
    jm, jp, tm, tp = _pair(approx, **over)
    _, emb = _inputs(frames, batch=B if frames == 8 else 1)
    want = jax.jit(lambda p, e: jm._encode(p, e, CTX))(jp, emb)
    got = tm._encode(tp, T(emb))
    rel = _rel(got, want)
    print(f"frames={frames} approx={approx}: encoder rel {rel:.2e}")
    assert got.shape == emb.shape[:2] + (128,)
    assert rel <= (ENC_RAPID_RTOL if approx and frames > 8 else RTOL)


def test_rapid_attention_over_1100_frames_on_reference_inputs():
    """The RAPID attention core over 1100 frames (one bidirectional q
    chunk) on the reference's own q / k / v, split where the encoder's
    error at 1100 frames comes from: the exact scores within RTOL; the
    K3 softmax divide on the reference's own ``exp`` rows of 1100: the
    same bits once fed the reference's row sums, within SOFTMAX_1100_ULP
    end to end (ROADMAP rule 3: the row sums are grouped otherwise; the
    divide itself does not drift with the row width); the value product of the reference's probabilities within
    RTOL; so every probability row past RTOL of the reference's is a row
    whose inputs differ by ulps (a cell crossing), and the core's output
    stays within ATTN_1100_RTOL with at most ATTN_1100_SHARE of it past
    RTOL."""
    jc, tc = _cfgs(True)
    sch = tc.approx.div("softmax")
    rng = np.random.default_rng(6)
    q, k, v = (_rand(rng, 1, 1100, 4, 32, scale=s) for s in (0.5, 1, 1))
    pos = np.arange(1100, dtype=np.int32)

    def ref_parts(q, k, v):
        s = jlayers.exact_einsum("bshd,bthd->bhst", q, k)
        e = jnp.exp(s - s.max(axis=-1, keepdims=True))
        p = jlayers.qsoftmax_div(e, sch,
                                 backend=jc.approx.backend_for("softmax"))
        pv = jlayers.exact_einsum("bhst,bthd->bshd", p, v)
        out = jlayers._attn_qchunk_core(q, k, v, jnp.asarray(pos),
                                        jnp.asarray(pos), 0, False, jc.approx)
        return s, e, p, pv, out

    s, e, p, pv, out = map(np.array, jax.jit(ref_parts)(q, k, v))
    ts = tlayers.exact_einsum("bshd,bthd->bhst", T(q), T(k))
    te = torch.exp(ts - ts.amax(dim=-1, keepdim=True))
    tp = tlayers.qsoftmax_div(te, sch)
    tout = tlayers._attn_qchunk_core(T(q), T(k), T(v), T(pos), T(pos), 0,
                                     False, tc.approx)
    assert _rel(ts, s) <= RTOL
    den = jfd.softmax_denom(jfd.pad_lanes(jnp.asarray(e)), jfd.SOFTMAX_FLOOR)
    shared = tfa.log_div_f32(T(e), T(np.array(den)), tfa.div_lut_device(sch))
    assert_same_bits(shared.numpy(), p)
    ulp = ulp_diff(tlayers.qsoftmax_div(T(e), sch).numpy(), p).max()
    assert ulp <= SOFTMAX_1100_ULP
    assert _rel(tlayers.exact_einsum("bhst,bthd->bshd", T(p), T(v)),
                pv) <= RTOL
    off = (np.abs(tp.numpy() - p) > RTOL * np.abs(p).max()).any(-1)
    same_in = (te.numpy() == e).all(-1)
    assert not (off & same_in).any()
    d = np.abs(tout.numpy() - out) / np.abs(out).max()
    print(f"1100 frames: scores {_rel(ts, s):.2e}, divide {ulp} ulp, "
          f"probability rows off "
          f"{off.mean():.2e}, core {d.max():.2e}, "
          f"past RTOL {(d > RTOL).mean():.2e}")
    assert d.max() <= ATTN_1100_RTOL
    assert (d > RTOL).mean() <= ATTN_1100_SHARE


@pytest.mark.parametrize("approx", [False, True])
def test_qchunk_tail_padding_changes_no_row(approx):
    """The port runs the last q chunk of a 1100-row bidirectional
    attention as its 76 rows alone; the reference pads it to 1024 rows
    at position 0.  The port's core on the padded chunk gives the same
    bits in those 76 rows: the padding changes no row."""
    tc = _cfgs(approx)[1]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((B, 1100, 4, 32), generator=g) for _ in range(3))
    pos = torch.arange(1100, dtype=torch.int32)
    out = tlayers._attn_plain(q, k, v, pos, pos, 0, False, tc.approx)
    qs = q.float() * tlayers._attn_scale(32)
    padded = torch.cat([qs[:, 1024:], torch.zeros((B, 948, 4, 32))], 1)
    qpos = torch.cat([pos[1024:], torch.zeros(948, dtype=torch.int32)])
    tail = tlayers._attn_qchunk_core(padded, k, v, qpos, pos, 0, False,
                                     tc.approx)[:, :76]
    assert_same_bits(out[:, 1024:].numpy(), tail.numpy())


def test_kept_cross_kv_equal_the_recomputed():
    """Prefill keeps the cross k/v its cross-attention computed; the
    reference projects the encoder's output a second time (``dense(
    enc_out, xattn.wk / wv)``).  On the same ``enc_out`` the two are the
    same bits (RAPID: the reference's own recomputation; EXACT: the
    port's, one product either way)."""
    toks, emb = _inputs()
    for approx in (True, False):
        jc, tc = _cfgs(approx)
        _, _, tm, tp = _pair(approx)
        enc = tm._encode(tp, T(emb))
        _, cache = tm.prefill(tp, {"tokens": T(toks), "enc_embeds": T(emb)},
                              CACHE_N)
        for i, lc in enumerate(cache["layers"]):
            xp = tp["blocks"][i]["xattn"]
            for name, w in (("ck", "wk"), ("cv", "wv")):
                own = tlayers.dense(enc, xp[w], tc.approx, "attn_proj")
                assert_same_bits(lc[name].numpy().reshape(own.shape),
                                 own.numpy())
                if approx:
                    ref = jlayers.dense(jnp.asarray(enc.numpy()),
                                        jnp.asarray(xp[w].numpy()),
                                        jc.approx, "attn_proj")
                    assert_same_bits(lc[name].numpy().reshape(own.shape),
                                     np.asarray(ref))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _reference_run(approx):
    """The reference on ``_inputs()``, as numpy: forward logits, prefill
    logits and cache, then STEPS greedy decode steps (logits, tokens)."""
    jm, jp, _, _ = _pair(approx)
    toks, emb = _inputs()
    batch = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(emb)}
    fwd = np.asarray(jax.jit(lambda p, b: jm.forward(p, b, CTX))(jp, batch))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, CTX, CACHE_N))(jp, batch)
    cache = jax.tree.map(np.asarray, jc)
    dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))
    logits, tokens = [np.asarray(jl)], []
    for _ in range(STEPS):
        nt = np.asarray(jl).argmax(-1).astype(np.int32)
        tokens.append(nt)
        jl, jc = dec(jp, jnp.asarray(nt), jc)
        logits.append(np.asarray(jl))
    return fwd, cache, logits, tokens


@pytest.mark.parametrize("approx", [False, True])
def test_forward_prefill_and_greedy_decode_match_reference(approx):
    """``forward`` and ``prefill`` logits within EXACT_ATOL / RAPID_ATOL
    of the reference's; prefill's cache (``pos``, ``slots``, every
    layer's ``k`` / ``v`` / ``ck`` / ``cv``) within the same bound; then
    STEPS greedy ``decode_step``s, each side on its own tokens, driven
    through a ``CompiledStep`` (one trace for all of them): every step's
    logits within the bound and the greedy tokens 100% equal."""
    fwd, jcache, jlogits, jtokens = _reference_run(approx)
    _, _, tm, tp = _pair(approx)
    atol = RAPID_ATOL if approx else EXACT_ATOL
    near = partial(np.testing.assert_allclose, atol=atol, rtol=0)
    toks, emb = _inputs()
    batch = {"tokens": T(toks), "enc_embeds": T(emb)}
    got = tm.forward(tp, batch)
    print(f"approx={approx}: forward max |diff| "
          f"{np.abs(got.numpy() - fwd).max():.3e} of {np.abs(fwd).max():.2f}")
    near(got.numpy(), fwd)
    tl, cache = tm.prefill(tp, batch, CACHE_N)
    assert int(cache["pos"]) == int(jcache["pos"]) == S
    np.testing.assert_array_equal(cache["slots"].numpy(), jcache["slots"])
    for i, lc in enumerate(cache["layers"]):
        ref = jcache["layers"][f"l{i}"]
        assert sorted(lc) == sorted(ref)
        for k, t in lc.items():
            assert tuple(t.shape) == ref[k].shape, k
            near(t.numpy(), ref[k], err_msg=f"layer {i} {k}")
    trace_counts = {"decode": 0}
    step = CompiledStep("decode", trace_counts, "cpu")
    diffs = []
    for i, want in enumerate(jlogits):
        diffs.append(float(np.abs(tl.numpy() - want).max()))
        near(tl.numpy(), want, err_msg=f"step {i}")
        if i == STEPS:
            break
        nt = tl.numpy().argmax(-1).astype(np.int32)
        assert np.array_equal(nt, jtokens[i]), i
        tl = step(lambda t: tm.decode_step(tp, t, cache)[0], T(nt), key=0)
    print(f"  prefill + {STEPS} decode steps: max |diff| {diffs}")
    assert trace_counts == {"decode": 1}
    assert int(cache["pos"]) == S + STEPS
