"""The port's kernel modules held against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays.  Every tolerance is relative to the reference's magnitude
(`_assert_rel`): f32 paths agree to float32 rounding (1e-5), bf16
outputs to one bf16 rounding step (2^-7 relative).

  * decode step: the port's plain decode (functional and the in-place
    fused family) vs `repro.kernels.ops.la_decode_step_fused` under the
    "xla" and "pallas_interpret" impls, g in {1, 4}, f32 and bf16, and
    a row whose normalizer is exactly zero
  * prefill with state in and out vs `repro.core.chunked.la_fwd_chunked`
    at odd N and chunk in {4, 16}; prefill(state) + decode == prefill
    of the longer sequence
  * l2_normalize, safe_div, partial rope, layernorm and tanh-gelu parity
  * the impl registry: unknown names, device-picked "auto", "cuda" on
    a CPU tensor
  * training's causal LA (`ops.la_causal`, an autograd Function) at odd
    N = 37, g in {1, 4} and chunk in {4, 16}: o and g against the
    reference's `la_causal` / `la_fwd_chunked` ("xla", plus one
    "pallas_interpret" case), and dq/dk/dv against `jax.vjp` through
    `ops.la_causal`, each grad held to 1e-5 of its own largest |value|
    (the gradients' magnitudes differ by orders, ROADMAP queue 3);
    `la_causal_learnable`'s da and db; the `ref` impl against `torch`
  * `gpu`-marked CUDA kernel-vs-plain tests (skip without a card)

Where JAX is installed the reference runs on the CPU, in f32 (JAX on a
card computes an f32 dot in TF32 by default); the machine with the card
has JAX with a CUDA backend, so the pin matters there.  Without JAX the
reference tests skip and the gpu test runs alone.
"""
import numpy as np
import pytest
import torch

try:
    import jax

    # the reference on the CPU, where an f32 dot is an f32 dot (JAX on a
    # card computes it in TF32 by default)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from repro.core import chunked as jchunked
    from repro.core import numerics as jnum
    from repro.kernels import ops as jops
    from repro.models import common as jcommon
    from repro.models import rope as jrope
except ImportError:  # the port alone, without JAX
    jax = None
from repro_torch.core import chunked as tchunked
from repro_torch.core import numerics as tnum
from repro_torch.core import linear_attention as tla
from repro_torch.configs.base import LACfg
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import ops as tops
from repro_torch.models import common as tcommon
from repro_torch.models import rope as trope

F32_REL = 1e-5          # float32 rounding, relative to max |reference|
BF16_REL = 2.0 ** -7    # one bf16 rounding step of the output


def _assert_rel(got, want, rel, label=""):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} * {scale}"


def _unit_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _warm_state(rng, b, hkv, d, steps=3):
    """A populated recurrent state: `steps` rank-1 updates with unit k."""
    s = np.zeros((b, hkv, d, d + 1), np.float32)
    p = np.zeros((b, hkv, d + 1), np.float32)
    for _ in range(steps):
        k = _unit_rows(rng, (b, hkv, d))
        vaug = np.concatenate([rng.standard_normal((b, hkv, d)),
                               np.ones((b, hkv, 1))], -1).astype(np.float32)
        s += k[..., :, None] * vaug[..., None, :]
        p += vaug
    return s, p


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed here")


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _decode_inputs(g, zero_den=False, seed=0):
    rng = np.random.default_rng(seed)
    b, hkv, d = 3, 2, 8
    s, p = _warm_state(rng, b, hkv, d)
    q = _unit_rows(rng, (b, hkv * g, d))
    k = _unit_rows(rng, (b, hkv, d))
    v = rng.standard_normal((b, hkv, d)).astype(np.float32)
    if zero_den:
        # slot 0, KV head 0: after the update p[dv] == 0 and q == 0, so
        # f's normalizer is exactly 0 while its numerators are not
        p[0, 0, d] = -1.0
        q[0, :g] = 0.0
    return s, p, q, k, v


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_den", [False, True])
def test_decode_step_matches_jax(impl, g, dtype, zero_den):
    a, b = 1.0, 0.5
    s, p, q, k, v = _decode_inputs(g, zero_den)
    jdt = _jdt(dtype)
    jst, jo = jops.la_decode_step_fused(
        jops.LAState(jnp.asarray(s), jnp.asarray(p)),
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), a, b, backend=impl)
    out_rel = BF16_REL if dtype == torch.bfloat16 else F32_REL

    # the in-place fused family (the CPU side of the kernel's wrapper)
    st = tchunked.LAState(_t(s), _t(p))
    s_ptr = st.s.data_ptr()
    st2, o = tops.la_decode_step_fused(st, _t(q, dtype), _t(k, dtype),
                                       _t(v, dtype), a, b, backend="auto")
    assert st2.s.data_ptr() == s_ptr and o.dtype == dtype
    _assert_rel(st2.s, jst.s, F32_REL, "fused s")
    _assert_rel(st2.p, jst.p, F32_REL, "fused p")
    _assert_rel(o, np.asarray(jo.astype(jnp.float32)), out_rel, "fused o")

    # the functional plain step
    st3, o3 = tchunked.la_decode_step(
        tchunked.LAState(_t(s), _t(p)), _t(q, dtype), _t(k, dtype),
        _t(v, dtype), a, b)
    _assert_rel(st3.s, jst.s, F32_REL, "plain s")
    _assert_rel(o3, np.asarray(jo.astype(jnp.float32)), out_rel, "plain o")
    if zero_den:
        assert float(o[0, :g].float().abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Prefill (chunked scan with state in and out)
# ---------------------------------------------------------------------------

def _seq_inputs(rng, b, h, hkv, n, d):
    q = _unit_rows(rng, (b, h, n, d))
    k = _unit_rows(rng, (b, hkv, n, d))
    v = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_prefill_with_state_matches_jax(chunk, g):
    rng = np.random.default_rng(1)
    b, hkv, n, d = 2, 2, 13, 8
    a, bb = 1.0, 1.0
    s0, p0 = _warm_state(rng, b, hkv, d)
    q, k, v = _seq_inputs(rng, b, hkv * g, hkv, n, d)
    jo, jg, jst = jchunked.la_fwd_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), a, bb, chunk,
        state=jchunked.LAState(jnp.asarray(s0), jnp.asarray(p0)))
    o, st = tops.la_prefill(_t(q), _t(k), _t(v), a, bb, chunk,
                            state=tchunked.LAState(_t(s0), _t(p0)))
    _assert_rel(o, jo, F32_REL, "o")
    _assert_rel(st.s, jst.s, F32_REL, "s")
    _assert_rel(st.p, jst.p, F32_REL, "p")
    _, tg, _ = tchunked.la_fwd_chunked(_t(q), _t(k), _t(v), a, bb, chunk)
    jg0 = jchunked.la_fwd_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), a, bb, chunk)[1]
    _assert_rel(tg, jg0, F32_REL, "g")


@pytest.mark.parametrize("g", [1, 4])
def test_prefill_then_decode_equals_longer_prefill(g):
    rng = np.random.default_rng(2)
    b, hkv, n, d = 2, 2, 11, 8
    q, k, v = _seq_inputs(rng, b, hkv * g, hkv, n + 1, d)
    o_full, st_full = tops.la_prefill(_t(q), _t(k), _t(v), chunk=4)
    _, st = tops.la_prefill(_t(q[:, :, :n]), _t(k[:, :, :n]),
                            _t(v[:, :, :n]), chunk=4)
    st, o_last = tops.la_decode_step_fused(
        st, _t(q[:, :, n]), _t(k[:, :, n]), _t(v[:, :, n]))
    _assert_rel(o_last, o_full[:, :, n], F32_REL, "o")
    _assert_rel(st.s, st_full.s, F32_REL, "s")
    _assert_rel(st.p, st_full.p, F32_REL, "p")


# ---------------------------------------------------------------------------
# Elementwise numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_normalize_matches_jax(dtype):
    x = np.random.default_rng(3).standard_normal((4, 5, 16)).astype(
        np.float32)
    x[0, 0] = 0.0   # eps inside the sqrt keeps a zero row finite (zero)
    want = jnum.l2_normalize(jnp.asarray(x).astype(_jdt(dtype)))
    got = tnum.l2_normalize(_t(x, dtype))
    assert got.dtype == dtype
    rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
    _assert_rel(got, np.asarray(want.astype(jnp.float32)), rel)


def test_safe_div_matches_jax():
    rng = np.random.default_rng(4)
    num = rng.standard_normal((6, 5)).astype(np.float32)
    den = rng.standard_normal((6, 1)).astype(np.float32)
    den[1] = 0.0
    den[2] = 1e-31
    want = jnum.safe_div(jnp.asarray(num), jnp.asarray(den))
    got = tnum.safe_div(_t(num), _t(den))
    _assert_rel(got, want, F32_REL)
    assert float(got[1:3].abs().max()) == 0.0


@pytest.mark.parametrize("kind,fraction", [("partial", 0.25),
                                           ("standard", 1.0)])
def test_rope_matches_jax(kind, fraction):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), kind,
                            fraction)
    got = trope.apply_rope(_t(x), torch.from_numpy(pos), kind, fraction)
    _assert_rel(got, want, F32_REL)
    if kind == "partial":   # dims past rot_dim = 8 pass through untouched
        assert torch.equal(got[..., 8:], _t(x)[..., 8:])


def test_layernorm_and_tanh_gelu_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    want = jcommon.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), "layernorm")
    got = tcommon.norm_apply({k: _t(v) for k, v in p.items()}, _t(x))
    _assert_rel(got, want, F32_REL, "layernorm")
    _assert_rel(torch.nn.functional.gelu(_t(x), approximate="tanh"),
                jax.nn.gelu(jnp.asarray(x)), F32_REL, "gelu")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_unknown_impl_lists_registered():
    with pytest.raises(ValueError,
                       match=r"registered: \['cuda', 'ref', 'torch'\]"):
        tops.get_kernel("linear_decode_fused", "pallas")
    assert tops.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert tops.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert tops.get_kernel("linear_decode_fused", "auto",
                           torch.device("cpu")).name == "torch"


def test_cuda_impl_raises_on_cpu_tensors():
    s, p, q, k, v = _decode_inputs(1)
    st = tchunked.LAState(_t(s), _t(p))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.la_decode_step_fused(st, _t(q), _t(k), _t(v), backend="cuda")
    assert torch.equal(st.s, _t(s))   # nothing was touched


# ---------------------------------------------------------------------------
# The CUDA kernel (card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_kernel_matches_plain(dtype, g):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    s, p, q, k, v = _decode_inputs(g, zero_den=True)
    dev = torch.device("cuda")
    args = [_t(x, dtype).to(dev) for x in (q, k, v)]
    s_k, p_k = _t(s).to(dev), _t(p).to(dev)
    s_ptr = s_k.data_ptr()
    before = tdf.launches["la_decode_fused"]
    o_k = tdf.la_decode_fused_cuda(s_k, p_k, *args, 1.0, 0.5)
    torch.cuda.synchronize()
    assert tdf.launches["la_decode_fused"] == before + 1 \
        and s_k.data_ptr() == s_ptr
    s_t, p_t = _t(s).to(dev), _t(p).to(dev)
    o_t = tdf.la_decode_fused_torch(s_t, p_t, *args, 1.0, 0.5)
    rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
    _assert_rel(s_k.cpu(), s_t.cpu().numpy(), F32_REL, "s")
    _assert_rel(p_k.cpu(), p_t.cpu().numpy(), F32_REL, "p")
    _assert_rel(o_k.cpu(), o_t.float().cpu().numpy(), rel, "o")


# ---------------------------------------------------------------------------
# Training: causal LA forward + analytic backward (ops.la_causal)
# ---------------------------------------------------------------------------

LA_N, LA_D = 37, 8          # odd N: the last chunk is ragged
LA_CASES = [("xla", 1, 4), ("xla", 1, 16), ("xla", 4, 4), ("xla", 4, 16),
            ("pallas_interpret", 4, 16)]
_JAX_LA = {}


def _la_inputs(g, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v = _seq_inputs(rng, 2, 2 * g, 2, LA_N, LA_D)
    omega = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, omega


def _jax_la(impl, g, chunk, a=1.0, b=0.5):
    """The reference's o, g, (dq, dk, dv) for one case (computed once)."""
    key = (impl, g, chunk, a, b)
    if key not in _JAX_LA:
        fwd = jops.get_kernel("linear", impl).fwd

        @jax.jit
        def run(q_, k_, v_, om_):
            o, vjp = jax.vjp(lambda *x: jops.la_causal(*x, a, b, chunk,
                                                       impl), q_, k_, v_)
            return o, fwd(q_, k_, v_, a, b, chunk)[1], vjp(om_)

        o, gn, grads = run(*(jnp.asarray(x) for x in _la_inputs(g)))
        _JAX_LA[key] = (np.asarray(o), np.asarray(gn),
                        [np.asarray(x) for x in grads])
    return _JAX_LA[key]


def _port_la(backend, g, chunk, a=1.0, b=0.5):
    q, k, v, omega = _la_inputs(g)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = tops.la_causal(*leaves, a, b, chunk, backend)
    o.backward(_t(omega))
    return o.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("impl,g,chunk", LA_CASES)
def test_la_causal_forward_matches_jax(impl, g, chunk):
    jo, jg, _ = _jax_la(impl, g, chunk)
    o, _ = _port_la("auto", g, chunk)
    _assert_rel(o, jo, F32_REL, "o")
    q, k, v, _ = _la_inputs(g)
    _, tg = tops.get_kernel("linear", "torch").fwd(_t(q), _t(k), _t(v),
                                                   1.0, 0.5, chunk)
    _assert_rel(tg, jg, F32_REL, "g")


@pytest.mark.parametrize("impl,g,chunk", LA_CASES)
def test_la_causal_grads_match_jax(impl, g, chunk):
    _, _, jgrads = _jax_la(impl, g, chunk)
    _, grads = _port_la("torch", g, chunk)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.shape == want.shape, name
        _assert_rel(got, want, F32_REL, name)


@pytest.mark.parametrize("g", [1, 4])
def test_la_causal_learnable_grads_match_jax(g):
    q, k, v, omega = _la_inputs(g, seed=8)
    a0, b0 = 0.7, 1.3
    jargs = [jnp.asarray(x) for x in (q, k, v)] + [jnp.float32(a0),
                                                   jnp.float32(b0)]

    @jax.jit
    def run(om_, *xs):
        o, vjp = jax.vjp(lambda *x: jops.la_causal_learnable(*x, 4, "xla"),
                         *xs)
        return o, vjp(om_)

    jo, jgrads = run(jnp.asarray(omega), *jargs)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)] + [
        torch.tensor(a0, requires_grad=True),
        torch.tensor(b0, requires_grad=True)]
    o = tops.la_causal_learnable(*leaves, 4, "torch")
    o.backward(_t(omega))
    _assert_rel(o.detach(), jo, F32_REL, "o")
    for name, x, want in zip(("dq", "dk", "dv", "da", "db"), leaves,
                             jgrads):
        _assert_rel(x.grad, np.asarray(want), F32_REL, name)
    # o depends on a/b only: a da + b db = 0
    assert abs(a0 * float(leaves[3].grad) + b0 * float(leaves[4].grad)) \
        <= F32_REL * abs(a0 * float(leaves[3].grad))


@pytest.mark.parametrize("g", [1, 4])
def test_ref_impl_matches_torch_impl(g):
    o_ref, grads_ref = _port_la("ref", g, 4)
    o, grads = _port_la("torch", g, 4)
    _assert_rel(o, o_ref.numpy(), F32_REL, "o")
    q, k, v, _ = _la_inputs(g)
    want = tops.get_kernel("linear", "ref").fwd(_t(q), _t(k), _t(v), 1.0,
                                                0.5, 4)[1]
    got = tops.get_kernel("linear", "torch").fwd(_t(q), _t(k), _t(v), 1.0,
                                                 0.5, 4)[1]
    _assert_rel(got, want.numpy(), F32_REL, "g")
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        _assert_rel(got, want.numpy(), F32_REL, name)


def test_la_attention_normalizes_and_is_causal_only():
    q, k, v, _ = _la_inputs(1)
    cfg = LACfg(chunk=16, backend="torch")
    o = tla.la_attention(_t(q) * 3.0, _t(k) * 0.5, _t(v), cfg)
    want = tops.la_causal(tnum.l2_normalize(_t(q) * 3.0),
                          tnum.l2_normalize(_t(k) * 0.5), _t(v), cfg.a,
                          cfg.b, cfg.chunk, "torch")
    assert torch.equal(o, want)
    # causal=False (the encoder and cross-attention): the non-causal form
    # on the normalized q and k
    o = tla.la_attention(_t(q) * 3.0, _t(k) * 0.5, _t(v), cfg, causal=False)
    want = tops.la_noncausal(tnum.l2_normalize(_t(q) * 3.0),
                             tnum.l2_normalize(_t(k) * 0.5), _t(v), cfg.a,
                             cfg.b)
    assert torch.equal(o, want)


def test_linear_registry_and_cuda_on_cpu_raises():
    assert tops.kernel_names("linear") == ["cuda", "ref", "torch"]
    assert tops.get_kernel("linear", "auto",
                           torch.device("cpu")).name == "torch"
    q, k, v, _ = _la_inputs(1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.la_causal(_t(q), _t(k), _t(v), backend="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_la_kernels_match_plain(dtype, g):
    """la_fwd, la_bwd_q and la_bwd_kv against their plain versions at
    odd N, D = 32: f32 to 1e-5 of each output's largest |value| (the
    kernels sum token by token, the plain scans chunk by chunk), bf16
    outputs to one bf16 rounding step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    q, k, v = _seq_inputs(rng, 2, 2 * g, 2, LA_N, 32)
    omega = rng.standard_normal(q.shape).astype(np.float32)
    q, k, v = (_t(x, dtype).to(dev) for x in (q, k, v))
    omega = _t(omega).to(dev)
    rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
    before = dict(tkla.launches)
    o_k, g_k = tkla.la_fwd_cuda(q, k, v, 1.0, 0.5)
    o_t, g_t = tkla.la_fwd_torch(q, k, v, 1.0, 0.5, 16)
    om_hat, h_vec = tchunked.la_bwd_prep(o_t, g_t, omega)
    dq_k = tkla.la_bwd_q_cuda(k, v, om_hat, h_vec, 0.5)
    dk_k, dv_k = tkla.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 0.5)
    torch.cuda.synchronize()
    assert {n: tkla.launches[n] - before[n] for n in before} == {
        "la_fwd": 1, "la_bwd_q": 1, "la_bwd_kv": 1}
    dq_t = tkla.la_bwd_q_torch(k, v, om_hat, h_vec, 0.5, 16)
    dk_t, dv_t = tkla.la_bwd_kv_torch(q, k, v, om_hat, h_vec, 1.0, 0.5, 16)
    for name, got, want in (("o", o_k, o_t), ("dq", dq_k, dq_t),
                            ("dk", dk_k, dk_t), ("dv", dv_k, dv_t)):
        assert got.dtype == dtype, name
        _assert_rel(got.cpu(), want.float().cpu().numpy(), rel, name)
    _assert_rel(g_k.cpu(), g_t.cpu().numpy(), F32_REL, "g")
