"""The port's dense model against the JAX reference (CPU, plain torch).

Reduced h2o_danube_1_8b (GQA, sliding window), minicpm_2b (MHA, tied
embeddings) and starcoder2_7b (LN with its bias, the ungated gelu MLP)
at float32, RAPID and EXACT, with the reference's params carried over by
``load_jax_params`` (LN scales and biases drawn away from the
reference's ones and zeros, so both reach the logits).  The reference
arm is the jitted ``jnp`` backend.

Tolerances: EXACT logits within atol 1e-4 (f32; only summation orders
differ).  RAPID logits within atol 1e-2 of logits of size ~1-4: the
reference's model matmuls sum in chunks of 64 (``core/ops.py:119``),
the port one k at a time, and a RAPID product jumps by up to a few
percent when a one-ulp input change moves an operand's 4-bit mantissa
index into the next coefficient cell (measured worst case 2.3e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import perturb_ln  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params  # noqa: E402

CTX = ParallelCtx()
CACHE_N = 16


def _pair(arch, approx, scan_layers=False, **over):
    jc = jget(arch).reduced().with_(dtype="float32", scan_layers=scan_layers,
                                    **over)
    tc = tget(arch).reduced().with_(dtype="float32", **over)
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    jc = jc.with_backend("jnp")
    jm, tm = JModel(jc), TModel(tc)
    jp = perturb_ln(jm.init(jax.random.PRNGKey(0)))
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch,approx,scan_layers", [
    ("h2o_danube_1_8b", True, False),
    ("h2o_danube_1_8b", False, False),
    ("minicpm_2b", True, False),
    ("minicpm_2b", False, False),
    ("h2o_danube_1_8b", True, True),   # the stacked-params loader
    ("starcoder2_7b", True, False),
    ("starcoder2_7b", False, False),
])
def test_prefill_and_decode_match_reference(arch, approx, scan_layers):
    jm, jp, tm, tp = _pair(arch, approx, scan_layers)
    atol = 1e-2 if approx else 1e-4
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
    jpre = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, CTX, CACHE_N))
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))
    jl, jc = jpre(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CACHE_N)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    np.testing.assert_array_equal(tc["slots"].numpy(), np.asarray(jc["slots"]))
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jdec(jp, jnp.asarray(nt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        assert tc["pos"] == int(jc["pos"])
        np.testing.assert_array_equal(tc["slots"].numpy(),
                                      np.asarray(jc["slots"]))
        nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_ring_cache_smaller_than_sequence():
    """Sliding window 8 < 12 prompt tokens: the ring layout and its slot
    positions match the reference, and decode keeps agreeing."""
    jm, jp, tm, tp = _pair("h2o_danube_1_8b", True, sliding_window=8)
    toks = np.random.default_rng(4).integers(0, 512, (1, 12)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, CTX, 20))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 20)
    assert tc["layers"][0]["k"].shape[1] == 8
    np.testing.assert_array_equal(tc["slots"].numpy(), np.asarray(jc["slots"]))
    np.testing.assert_allclose(tc["layers"][1]["v"].numpy(),
                               np.asarray(jc["layers"]["l1"]["v"]), atol=1e-2)
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))
    for _ in range(2):
        jl, jc = jdec(jp, jnp.asarray(nt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2)
        nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_init_matches_reference_distributions():
    """The port's own seeded init: the reference's shapes, dtypes and
    std per leaf (0.02 for the embedding, 1/sqrt(fan_in) otherwise)."""
    cfg = tget("h2o_danube_1_8b").reduced()
    p = TModel(cfg).init(0, "cpu")
    jp = JModel(jget("h2o_danube_1_8b").reduced()).init(jax.random.PRNGKey(0))
    ref = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(p) == sorted(ref)
    assert len(p["blocks"]) == len(ref["blocks"]) == cfg.n_layers
    for name, fan_in in (("wq", cfg.d_model), ("wo", cfg.n_heads * cfg.hd)):
        w = p["blocks"][0]["attn"][name]
        assert w.shape == ref["blocks"][0]["attn"][name].shape
        assert w.dtype == torch.float32
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    again = TModel(cfg).init(0, "cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])


def test_init_cache_matches_reference_layout():
    cfg = tget("h2o_danube_1_8b").reduced()
    cache = TModel(cfg).init_cache(3, 24, "cpu")
    ref = JModel(jget("h2o_danube_1_8b").reduced()).init_cache(3, 24)
    assert cache["pos"] == int(ref["pos"])
    np.testing.assert_array_equal(cache["slots"].numpy(),
                                  np.asarray(ref["slots"]))
    k = cache["layers"][0]["k"]
    assert tuple(k.shape) == ref["layers"]["l0"]["k"].shape
    assert k.dtype == torch.bfloat16 and not k.any()


def test_entry_points_default_to_cuda():
    model = TModel(tget("h2o_danube_1_8b").reduced())
    if torch.cuda.is_available():
        assert model.init(0)["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init(0)


_NUMERICS = ("torch.backends.cuda.matmul.allow_tf32",
             "torch.backends.cudnn.allow_tf32",
             "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction")


def _flags():
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
            b.cuda.matmul.allow_bf16_reduced_precision_reduction)


def test_load_jax_params_alone_sets_exact_numerics():
    """Weights carried over from the reference, with no Model.init or
    init_cache call, still run with TF32 and bf16 reduced-precision
    reductions off (the exact bf16 logits head depends on it)."""
    b = torch.backends
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    b.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    tree = {"embed": np.ones((4, 2), np.float32),
            "blocks": {"l0": {"w": np.ones((2, 2), np.float32)}}}
    load_jax_params(tree, device="cpu")
    assert _flags() == (False, False, False)


def test_importing_the_port_sets_exact_numerics():
    """A fresh process that only imports a port module has the switches
    off before any entry point runs."""
    import os
    import subprocess
    import sys
    code = ("import torch\nfrom repro_torch.serve.engine import ServeEngine\n"
            f"print(*[bool(eval(n)) for n in {_NUMERICS!r}])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False"] * 3


@pytest.mark.parametrize("over", [dict(act="gelu"), dict(norm="ln"),
                                  dict(act="gelu", norm="ln")])
def test_act_and_norm_variants_build_and_match_reference(over):
    """gelu (the ungated MLP, no w3) and LN (a bias beside each scale),
    alone and together, on reduced minicpm_2b: the port builds the
    reference's tree and its prefill and decode logits."""
    jm, jp, tm, tp = _pair("minicpm_2b", True, **over)
    ffn = {"w1", "w2"} if over.get("act") == "gelu" else {"w1", "w3", "w2"}
    assert set(tp["blocks"][0]["ffn"]) == ffn
    norm = {"scale", "bias"} if over.get("norm") == "ln" else {"scale"}
    assert set(tp["blocks"][0]["ln2"]) == set(tp["final_norm"]) == norm
    toks = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, CTX,
                                             CACHE_N))(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CACHE_N)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2, rtol=0)
    nt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, CTX))(
        jp, jnp.asarray(nt), jc)
    tl, _ = tm.decode_step(tp, torch.from_numpy(nt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2, rtol=0)


@pytest.mark.parametrize("over,match", [
    (dict(family="audio_lm"),
     r"the port has the families \(.dense., .moe., .hybrid., .ssm., "
     r".encdec., .vlm.\)"),
    (dict(act="relu"), "act='relu' is not ported"),
    (dict(norm="rmsnorm"), "norm='rmsnorm' is not ported")])
def test_model_refuses_other_families_and_blocks(over, match):
    """A family or block the port has not got would build another model
    than the reference's: refused."""
    with pytest.raises(NotImplementedError, match=match):
        TModel(tget("minicpm_2b").reduced().with_(**over))


def test_load_jax_params_carries_ln_bias_and_no_w3():
    """starcoder2_7b's reference tree (LN biases, no w3) arrives leaf for
    leaf: the port's own spec tree, the reference's values."""
    jm, jp, tm, tp = _pair("starcoder2_7b", False)
    want = jax.tree.map(np.asarray, jp)

    def paths(t, pre=()):
        if isinstance(t, dict):
            return {q for k, v in t.items() for q in paths(v, pre + (k,))}
        if isinstance(t, list):
            return {q for i, v in enumerate(t) for q in paths(v, pre + (i,))}
        return {pre}
    assert paths(tp) == paths(tm.param_specs())
    assert not any("w3" in q for q in paths(tp))
    for i, blk in enumerate(tp["blocks"]):
        for name in ("ln1", "ln2"):
            for leaf in ("scale", "bias"):
                np.testing.assert_array_equal(
                    blk[name][leaf].numpy(),
                    want["blocks"][f"l{i}"][name][leaf])
    np.testing.assert_array_equal(tp["final_norm"]["bias"].numpy(),
                                  want["final_norm"]["bias"])


def _numpy_params(model, seed):
    """Params of ``model``'s spec tree drawn by numpy (1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        fan = t.shape[0] if len(t.shape) > 1 else 1
        return torch.from_numpy((rng.standard_normal(t.shape)
                                 / np.sqrt(fan)).astype(np.float32))
    return walk(model.param_specs())


def _int_position_decode_step(model, params, tokens, cache, pos: int):
    """The decode step with ``pos`` a host int: the slot positions and
    the k/v ring slots written by a Python slice at ``pos % C``, ``pos``
    handed to the attention as an int (the route before the position
    became a device tensor)."""
    from repro_torch.models.layers import (apply_norm, decode_attention,
                                           dense, mlp, rope)
    cfg, acfg = model.cfg, model.cfg.approx
    x = model._embed(params, tokens[:, None])[:, 0]
    slots = cache["slots"]
    slots[:, pos % slots.shape[1]] = pos
    B, H, KV, hd = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for p, lc in zip(params["blocks"], cache["layers"]):
        h = apply_norm(x[:, None], p["ln1"], cfg)
        q = dense(h, p["attn"]["wq"], acfg, "attn_proj").reshape(B, H, hd)
        k = dense(h, p["attn"]["wk"], acfg, "attn_proj").reshape(B, KV, hd)
        v = dense(h, p["attn"]["wv"], acfg, "attn_proj").reshape(B, KV, hd)
        posv = torch.full((B, 1), pos, dtype=torch.int32)
        q = rope(q[:, None], posv, cfg.rope_theta)[:, 0]
        k = rope(k[:, None], posv, cfg.rope_theta)[:, 0]
        write = pos % lc["k"].shape[1]
        lc["k"][:, write] = k.to(lc["k"].dtype)
        lc["v"][:, write] = v.to(lc["v"].dtype)
        attn = decode_attention(q, lc["k"], lc["v"], slots, pos,
                                cfg.sliding_window, acfg)
        x = dense(attn[:, None], p["attn"]["wo"], acfg, "attn_proj",
                  residual=x[:, None])[:, 0]
        h2 = apply_norm(x[:, None], p["ln2"], cfg)
        x = mlp(h2, p["ffn"], cfg, residual=x[:, None])[:, 0]
    x = apply_norm(x[:, None], params["final_norm"], cfg)
    return model._logits(params, x)[:, 0]


def test_decode_step_tensor_position_keeps_the_int_routes_bits():
    """``cache["pos"]`` as an int32 device tensor (advanced in place, the
    ring slot written by ``index_copy_``) gives the bits of the int
    route (slice writes at ``pos % C``, the int position handed on): the
    logits and the caches of four decode steps on reduced
    h2o_danube_1_8b (RAPID, window 8, so the ring wraps)."""
    cfg = tget("h2o_danube_1_8b").reduced().with_(
        dtype="float32", approx=TRAPID, sliding_window=8)
    model = TModel(cfg)
    params = _numpy_params(model, 3)
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  20)
    ref_cache = {"slots": cache["slots"].clone(),
                 "layers": [{n: t.clone() for n, t in lc.items()}
                            for lc in cache["layers"]]}
    tok = ref_tok = logits.argmax(-1).to(torch.int32)
    for step in range(4):
        logits, cache = model.decode_step(params, tok, cache)
        ref = _int_position_decode_step(model, params, ref_tok, ref_cache,
                                        12 + step)
        assert torch.equal(logits.view(torch.int32), ref.view(torch.int32))
        tok = ref_tok = logits.argmax(-1).to(torch.int32)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].ndim == 0
    assert int(cache["pos"]) == 16
    assert torch.equal(cache["slots"], ref_cache["slots"])
    for lc, rc in zip(cache["layers"], ref_cache["layers"]):
        for n in ("k", "v"):
            assert torch.equal(lc[n].view(torch.int32),
                               rc[n].view(torch.int32))


def test_model_builds_silu_rms():
    cfg = tget("minicpm_2b").reduced().with_(act="silu", norm="rms")
    params = TModel(cfg).init(0, device="cpu")
    assert set(params["blocks"][0]["ffn"]) == {"w1", "w3", "w2"}
