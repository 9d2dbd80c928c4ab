"""The port's arithmetic core against the JAX reference (CPU, plain torch).

Contract: LUTs byte-equal; the float log-domain ops bit-exact, specials
and int32-wrap overflow included (north-star rule 2)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import bits, special_sample  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro.core import mitchell as jmit  # noqa: E402
from repro.core import schemes as jsch  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.core import mitchell as tmit  # noqa: E402
from repro_torch.core import schemes as tsch  # noqa: E402


@pytest.mark.parametrize("frac_bits", [23, 7, 15])
@pytest.mark.parametrize("kind,name", [("mul", n) for n in jsch.MUL_SCHEMES]
                         + [("div", n) for n in jsch.DIV_SCHEMES])
def test_lut_byte_equal(kind, name, frac_bits):
    jt = jsch.MUL_SCHEMES if kind == "mul" else jsch.DIV_SCHEMES
    tt = tsch.MUL_SCHEMES if kind == "mul" else tsch.DIV_SCHEMES
    assert sorted(jt) == sorted(tt)
    ref = jmit.lut_host(jt[name], frac_bits)
    got = tmit.lut_host(tt[name], frac_bits)
    assert got.dtype == ref.dtype == np.int32
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", list(jsch.MUL_SCHEMES))
def test_mul_lut_device_matches_host(name):
    got = tfa.mul_lut_device(name).numpy()
    assert got.tobytes() == np.asarray(jfa.mul_lut(name)).tobytes()


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = special_sample(rng, 256 * 1000).reshape(256, 1000)
    b = special_sample(rng, 256 * 1000).reshape(256, 1000)
    return a, b[rng.permutation(256)]


@pytest.mark.parametrize("name", list(jsch.MUL_SCHEMES))
def test_log_mul_f32_bit_exact(name):
    a, b = _operands(0)
    ref = jfa.log_mul_f32(jnp.asarray(a), jnp.asarray(b),
                          jfa.mul_lut_device(name))
    got = tfa.log_mul_f32(torch.from_numpy(a), torch.from_numpy(b),
                          tfa.mul_lut_device(name))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


@pytest.mark.parametrize("name", list(jsch.DIV_SCHEMES))
def test_log_div_f32_bit_exact(name):
    a, b = _operands(1)
    ref = jfa.log_div_f32(jnp.asarray(a), jnp.asarray(b),
                          jfa.div_lut_device(name))
    got = tfa.log_div_f32(torch.from_numpy(a), torch.from_numpy(b),
                          tfa.div_lut_device(name))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


def test_log_recip_f32_bit_exact():
    b = special_sample(np.random.default_rng(2), 4096)
    ref = jfa.log_recip_f32(jnp.asarray(b), jfa.div_lut_device("rapid9"))
    got = tfa.log_recip_f32(torch.from_numpy(b), tfa.div_lut_device("rapid9"))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


def test_overflow_wrap_saturates_to_inf():
    """Operands next to 0x7F7FFFFF wrap int32 in the log-domain add; the
    wrap test must turn that into +-inf, exactly as the reference."""
    big = np.array([0x7F7FFFFF, 0x7F000000, 0x7E800000], np.uint32).view(np.float32)
    a = np.repeat(big, 3)
    b = np.tile(big, 3)
    lut = tfa.mul_lut_device("rapid10")
    got = tfa.log_mul_f32(torch.from_numpy(a), torch.from_numpy(-b), lut).numpy()
    assert np.all(got == -np.inf)
    ref = jfa.log_mul_f32(jnp.asarray(a), jnp.asarray(-b),
                          jfa.mul_lut_device("rapid10"))
    np.testing.assert_array_equal(bits(got), bits(ref))
    tiny = np.full_like(a, 1e-30)
    q = tfa.log_div_f32(torch.from_numpy(a), torch.from_numpy(tiny),
                        tfa.div_lut_device("rapid9")).numpy()
    assert np.all(q == np.inf)


def test_non_float32_operands_raise():
    with pytest.raises(TypeError):
        tfa.log_mul_f32(torch.ones(3, dtype=torch.bfloat16), torch.ones(3),
                        tfa.mul_lut_device("rapid10"))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(arch, reduced):
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        if f.name == "approx":
            continue
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.hd, tc.padded_vocab) == (jc.hd, jc.padded_vocab)


@pytest.mark.parametrize("site", ["mlp", "attn_proj", "logits", "softmax",
                                  "norm"])
def test_approx_config_sites_match_reference(site):
    for jcfg, tcfg in ((jbase.RAPID, tbase.RAPID), (jbase.EXACT, tbase.EXACT)):
        if site in ("softmax", "norm"):
            assert tcfg.div(site) == jcfg.div(site)
        else:
            assert tcfg.mul(site) == jcfg.mul(site)
    assert tbase.RAPID.active and not tbase.EXACT.active
