"""The port's bfloat16 compute, the JAX package's default compute_dtype,
against the JAX package's on the CPU: instance norm's plain versions, the
three networks, inference, and the train step.

Instance norm's plain versions are held to the JAX contract element by
element: the forward against `instance_norm_reference` (and the Pallas
kernel, interpreted) in bf16, the backward against the custom VJP's `_bwd`
called with bf16 residuals. y and dx come back in bf16, within one bf16 ulp
of JAX's (rtol 2^-7) plus an atol: 1e-5 for y, where a ulp of a value below
~1e-3 is finer than the two frameworks' f32 rounding differences; 1e-4 for
dx, the atol that tests/test_torch_train_parts.py holds the f32 backward to,
since dx is a difference of sums of up to H*W terms. dgamma and dbeta are f32
and within rtol/atol 1e-3.

Everything else follows one gap rule. For each output or gradient o, with
||.|| the L2 norm relative to JAX's f32 value:
  d_jax   = ||o_jax,bf16 - o_jax,f32||    (JAX's own bf16 rounding)
  d_cross = ||o_port,bf16 - o_jax,bf16||  (the two bf16 implementations)
  d_port  = ||o_port,bf16 - o_port,f32||  (the port's own bf16 rounding)
It requires d_cross <= 2 d_jax (two independent bf16 roundings land about
sqrt(2) d_jax apart) and 0.25 d_jax <= d_port <= 4 d_jax (the port really
computes in bf16, and no worse than JAX does). The four runs of a case share
weights and inputs; bf16 rounds at other places in XLA and in PyTorch, so a
bf16 port cannot be held to f32's tolerances.

JAX runs compiled with XLA's `xla_allow_excess_precision` off. On the CPU,
XLA otherwise drops a rounding to bf16 that is followed by a widening to f32
(it fuses the two converts away), so its bf16 run would skip casts that the
JAX code writes, such as the rounding of a bf16 convolution's output before
SpecSeg's f32 sigmoid. With the option off XLA computes the program as
written, as the port does.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.infer import make_infer_fn as j_make_infer_fn
from shmgan_tpu.models.discriminator import SHMDiscriminator as JDisc
from shmgan_tpu.models.generator import SHMGenerator as JGenerator
from shmgan_tpu.models.specseg import SpecSeg as JSpecSeg
from shmgan_tpu.ops.pallas.instance_norm import (_bwd, instance_norm_pallas,
                                                 instance_norm_reference)
from shmgan_tpu.train.state import build_models as j_build_models
from shmgan_tpu.train.state import create_train_state as j_create_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.config import ModelConfig
from shmgan_tpu_torch.convert import load_flax, load_inference_weights, to_flax
from shmgan_tpu_torch.infer import make_infer_fn
from shmgan_tpu_torch.models import SHMDiscriminator, SHMGenerator, SpecSeg, build_models
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.serve import BatchInferenceEngine
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.train.step import Draws, make_train_step

DTYPES = ("bfloat16", "float32")
J_DTYPE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
T_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BF16_RTOL = 2.0 ** -7  # one bf16 ulp, relative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once, and torch's thread
    pool then contends with theirs, so the port runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_values(a):
    """a rounded to bf16 (to nearest even), as float32 numpy: exact in both
    frameworks' bf16."""
    return _t(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    return np.asarray(np.asarray(a).astype(np.float32), np.float64)


def _run_jax(jitted, *args):
    """jitted(*args), compiled with XLA's excess precision off (see above)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _gap_rule(name, port, jax_, lower=True):
    """port and jax_: {"bfloat16": o, "float32": o} of one output (an array,
    or a list of arrays taken as one vector). lower=False checks the two
    upper bounds only."""
    def vec(o):
        return np.concatenate([_f64(a).ravel() for a in o]) if isinstance(o, list) \
            else _f64(o).ravel()

    pb, pf, jb, jf = (vec(d[k]) for d, k in ((port, "bfloat16"), (port, "float32"),
                                             (jax_, "bfloat16"), (jax_, "float32")))
    assert pb.shape == jb.shape == jf.shape == pf.shape, name
    ref = np.linalg.norm(jf)
    d_jax, d_cross, d_port = (np.linalg.norm(a - b) / ref
                              for a, b in ((jb, jf), (pb, jb), (pb, pf)))
    msg = (f"{name}: d_jax={d_jax:.3e} d_cross/d_jax={d_cross / d_jax:.3f} "
           f"d_port/d_jax={d_port / d_jax:.3f}")
    print(msg)
    assert d_jax > 0, msg
    assert d_cross <= 2.0 * d_jax and d_port <= 4.0 * d_jax, msg
    assert not lower or d_port >= 0.25 * d_jax, msg
    return d_jax


# ---------------------------------------------------------------- config


def test_default_compute_dtype_is_jax_default():
    assert Config().model.compute_dtype == JConfig().model.compute_dtype == "bfloat16"
    gen, disc, specseg = build_models(Config(), device="cpu")
    assert gen.dtype == disc.dtype == specseg.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for m in (gen, disc, specseg) for p in m.parameters())


@pytest.mark.parametrize("name", ["float16", "float64", "bf16"])
def test_other_compute_dtypes_raise(name):
    with pytest.raises(ValueError):
        ModelConfig(compute_dtype=name)
    cfg = Config()
    cfg.model.compute_dtype = name
    with pytest.raises(ValueError):
        build_models(cfg, device="cpu")


# ------------------------------------------------- instance norm, plain versions

IN_SHAPES = [(2, 8, 16, 16), (3, 16, 4, 4), (2, 6, 7, 9), (1, 3, 5, 3)]


def _in_inputs(shape):
    b, c, h, w = shape
    x = _bf16_values(_np(51, shape, 2.0) + 0.5)
    g = _bf16_values(_np(52, shape))
    gamma, beta = 1.0 + _np(53, (c,), 0.2), _np(54, (c,), 0.1)
    return x, g, gamma, beta


def _nhwc_bf16(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)


def _assert_bf16_close(got, want, atol):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=atol)


@pytest.mark.parametrize("shape", IN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_instance_norm_plain_bf16_matches_reference(shape):
    x, _, gamma, beta = _in_inputs(shape)
    want = instance_norm_reference(_nhwc_bf16(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-6)
    got = ink.instance_norm(_t(x).bfloat16(), _t(gamma), _t(beta), 1e-6)
    _assert_bf16_close(got, jnp.transpose(want, (0, 3, 1, 2)), atol=1e-5)


def test_instance_norm_plain_bf16_matches_pallas_kernel_interpreted():
    shape = (2, 64, 16, 16)  # NCHW of the kernel's c = 64 case
    x, _, gamma, beta = _in_inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want = instance_norm_pallas(_nhwc_bf16(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-6)
    got = ink.instance_norm_plain(_t(x).bfloat16(), _t(gamma), _t(beta), 1e-6)
    _assert_bf16_close(got, jnp.transpose(want, (0, 3, 1, 2)), atol=1e-5)


@pytest.mark.parametrize("shape", IN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_instance_norm_backward_plain_bf16_matches_jax_bwd(shape):
    x, g, gamma, _ = _in_inputs(shape)
    xj = _nhwc_bf16(x)
    xf = xj.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)  # the residuals of _fwd
    var = jnp.mean(jnp.square(xf - mean), axis=(1, 2), keepdims=True)
    jdx, jdgamma, jdbeta = _bwd(1e-6, (xj, jnp.asarray(gamma), mean, var), _nhwc_bf16(g))
    assert jdgamma.dtype == jdbeta.dtype == jnp.float32
    b, c = shape[:2]
    t_mean = _t(np.asarray(mean).reshape(b, c))
    t_rstd = torch.rsqrt(_t(np.asarray(var).reshape(b, c)) + 1e-6)
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(
        _t(x).bfloat16(), _t(gamma), t_mean, t_rstd, _t(g).bfloat16())
    _assert_bf16_close(dx, jnp.transpose(jdx, (0, 3, 1, 2)), atol=1e-4)
    assert dgamma.dtype == dbeta.dtype == torch.float32
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(jdgamma), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(jdbeta), rtol=1e-3, atol=1e-3)


def test_instance_norm_bf16_gradients_reach_inputs():
    """On the CPU autograd differentiates the plain version through its f32
    casts: dx in bf16, dgamma and dbeta in f32, and they equal the plain
    backward's."""
    shape = (2, 4, 6, 6)
    x, g, gamma, beta = _in_inputs(shape)
    ins = [_t(x).bfloat16().requires_grad_(True), _t(gamma).requires_grad_(True),
           _t(beta).requires_grad_(True)]
    y = ink.instance_norm(*ins)
    assert y.dtype == torch.bfloat16
    y.backward(_t(g).bfloat16())
    assert ins[0].grad.dtype == torch.bfloat16 and ins[1].grad.dtype == torch.float32
    xf = ins[0].detach().float()
    mean = xf.mean(dim=(2, 3))
    rstd = torch.rsqrt((xf - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-6)
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(ins[0].detach(), ins[1].detach(),
                                                         mean, rstd, _t(g).bfloat16())
    torch.testing.assert_close(ins[0].grad.float(), dx.float(), rtol=BF16_RTOL, atol=1e-4)
    torch.testing.assert_close(ins[1].grad, dgamma, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ins[2].grad, dbeta, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- the networks


def _redraw(tree, seed):
    """Every leaf of a shape tree drawn from a numpy seed (variances positive,
    scales near 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items():
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                     1.0 + 0.1 * v if path[-1] == "scale" else 0.1 * v)
    return flax.traverse_util.unflatten_dict(out)


def _shapes(jmod, *args, **kwargs):
    return jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kwargs))


def _run_both(jax_fn, port_fn):
    """{dtype: outputs} of the JAX and the port side at both dtypes."""
    return ({d: jax_fn(d) for d in DTYPES},
            {d: port_fn(d) for d in DTYPES})


@pytest.fixture(scope="module")
def nets():
    """G, SpecSeg and D (eval mode, and its noise path with bf16 noise), each
    at both dtypes in both frameworks on the same weights."""
    out = {}
    x = _np(61, (2, 32, 32, 10))
    mask = np.random.default_rng(62).random((2, 32, 32, 1), dtype=np.float32)
    jg = {d: JGenerator(filter_size=8, c_dim=5, dtype=J_DTYPE[d]) for d in DTYPES}
    params = _redraw(_shapes(jg["float32"], jnp.asarray(x), jnp.asarray(mask))["params"], 63)

    def port_g(d):
        net = load_flax(SHMGenerator(filter_size=8, c_dim=5, dtype=T_DTYPE[d]), params)
        with torch.no_grad():
            return net(_t(x), _t(mask))

    out["G"] = _run_both(
        lambda d: _run_jax(jax.jit(jg[d].apply), {"params": params}, jnp.asarray(x),
                           jnp.asarray(mask)),
        port_g)

    y = _np(64, (2, 32, 32, 1))
    js = {d: JSpecSeg(base_filters=4, dtype=J_DTYPE[d]) for d in DTYPES}
    svars = _redraw(_shapes(js["float32"], jnp.asarray(y), train=False), 65)

    def port_s(d):
        net = SpecSeg(base_filters=4, in_channels=1, dtype=T_DTYPE[d])
        load_flax(net, svars["params"], svars["batch_stats"])
        with torch.no_grad():
            return net(_t(y))

    out["SpecSeg"] = _run_both(
        lambda d: _run_jax(jax.jit(lambda v, a: js[d].apply(v, a, train=False)), svars,
                           jnp.asarray(y)),
        port_s)

    size = 64  # D's last instance norm then normalises 2x2 planes
    img = np.random.default_rng(66).random((4, size, size, 3), np.float32)
    dmask = np.random.default_rng(67).random((4, size, size, 1), np.float32)
    noise = _bf16_values(_np(68, (4, 3, size, size)))  # a bf16 draw, as JAX's
    jd = {d: JDisc(filter_size=8, c_dim=5, dtype=J_DTYPE[d]) for d in DTYPES}
    dparams = _redraw(_shapes(jd["float32"], jnp.asarray(img), jnp.asarray(dmask))["params"],
                      69)
    dparams = jax.tree_util.tree_map(lambda a: a * 0.5, dparams)

    def jax_d(d, noisy):
        x_in = jnp.asarray(img).astype(J_DTYPE[d])
        if noisy:  # the module's own noise step, x + 0.1 * noise in x's dtype
            x_in = x_in + 0.1 * jnp.asarray(noise.transpose(0, 2, 3, 1)).astype(J_DTYPE[d])
        return _run_jax(jax.jit(lambda p, a, m: jd[d].apply({"params": p}, a, m, train=False)),
                        dparams, x_in, jnp.asarray(dmask))

    def port_d(d, noisy):
        net = SHMDiscriminator(filter_size=8, c_dim=5, image_size=size, dtype=T_DTYPE[d])
        load_flax(net, dparams)
        with torch.no_grad():
            return net(_t(img), _t(dmask), noise=_t(noise) if noisy else None)

    for noisy in (False, True):
        key = "D noise" if noisy else "D eval"
        out[key] = _run_both(lambda d: jax_d(d, noisy), lambda d: port_d(d, noisy))
    return out


NET_OUTPUTS = [("G", None), ("SpecSeg", None), ("D eval", 0), ("D eval", 1),
               ("D noise", 0), ("D noise", 1)]


@pytest.mark.parametrize("net,index", NET_OUTPUTS,
                         ids=[f"{n}-{'out' if i is None else ('patch', 'logits')[i]}"
                              for n, i in NET_OUTPUTS])
def test_network_gap_rule(nets, net, index):
    jax_out, port_out = nets[net]
    pick = (lambda o: o) if index is None else (lambda o: o[index])
    jb, pb = pick(jax_out["bfloat16"]), pick(port_out["bfloat16"])
    # output dtypes as JAX's: G's stays bf16, SpecSeg's and D's are cast to f32
    want_dtype = "bfloat16" if net == "G" else "float32"
    assert jb.dtype == J_DTYPE[want_dtype] and pb.dtype == T_DTYPE[want_dtype]
    _gap_rule(f"{net}[{index}]", {d: pick(port_out[d]) for d in DTYPES},
              {d: pick(jax_out[d]) for d in DTYPES})


# ---------------------------------------------------------------- inference

INFER_SIZE = 32


def _infer_configs(dtype):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(
        jcfg.model, image_size=INFER_SIZE, filter_size=8, specseg_base_filters=4,
        specseg_in_channels=2, upsample_mode="resize_conv", compute_dtype=dtype)
    jcfg.eval = dataclasses.replace(jcfg.eval, mask_tta=True, mask_chroma_prior=True)
    cfg = Config()
    for k in ("filter_size", "specseg_base_filters", "specseg_in_channels",
              "upsample_mode", "compute_dtype"):
        setattr(cfg.model, k, getattr(jcfg.model, k))
    cfg.eval.mask_tta, cfg.eval.mask_chroma_prior = True, True
    return jcfg, cfg


def _images(n, size, seed):
    """Smooth seeded scenes with a few bright, near-white highlights."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(n):
        base = rng.uniform(0.15, 0.6, 3)[None, None] * (0.6 + 0.4 * xx[..., None])
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.004)[..., None]
            base = base + (0.95 - base) * blob
        imgs.append(base + 0.02 * rng.standard_normal((size, size, 3)))
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def inference():
    jcfg, _ = _infer_configs("float32")
    gen, _, specseg = j_build_models(jcfg)
    s = INFER_SIZE
    shapes = jax.eval_shape(lambda: (
        gen.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 10)), jnp.zeros((1, s, s, 1)))
        ["params"],
        specseg.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 2)), train=False)))
    g_params, specseg_vars = _redraw(shapes[0], 71), _redraw(shapes[1], 72)
    rgb = _images(2, s, seed=73)

    def jax_side(d):
        return _run_jax(j_make_infer_fn(_infer_configs(d)[0], with_cyclic=True),
                        g_params, specseg_vars, jnp.asarray(rgb))

    def port_side(d):
        cfg = _infer_configs(d)[1]
        gen_t, _, specseg_t = build_models(cfg, device="cpu")
        load_inference_weights(gen_t, specseg_t, g_params, specseg_vars)
        return make_infer_fn(cfg, with_cyclic=True)(gen_t, specseg_t, _t(rgb))

    jax_out, port_out = _run_both(jax_side, port_side)
    cfg = _infer_configs("bfloat16")[1]
    gen_t, _, specseg_t = build_models(cfg, device="cpu")
    load_inference_weights(gen_t, specseg_t, g_params, specseg_vars)
    engine = BatchInferenceEngine(cfg, gen_t, specseg_t, batch_size=2, with_cyclic=True,
                                  device="cpu").process_images(rgb)
    return jax_out, port_out, engine


INFER_OUTPUTS = ["gen_rgb", "gen_rgb_denorm", "gen_rgb_calibrated", "gen_rgb_composited",
                 "mask", "gen_y", "cyc_rgb"]


@pytest.mark.parametrize("key", INFER_OUTPUTS)
def test_inference_gap_rule(inference, key):
    jax_out, port_out, engine = inference
    # gen_y stays in the compute dtype, as JAX returns it; the rest is f32
    want_dtype = "bfloat16" if key == "gen_y" else "float32"
    assert jax_out["bfloat16"][key].dtype == J_DTYPE[want_dtype]
    assert port_out["bfloat16"][key].dtype == T_DTYPE[want_dtype]
    _gap_rule(key, {d: port_out[d][key] for d in DTYPES},
              {d: jax_out[d][key] for d in DTYPES})
    # the engine hands back f32 numpy, the same values
    assert engine[key].dtype == np.float32
    np.testing.assert_array_equal(engine[key], _f64(port_out["bfloat16"][key]))


# ---------------------------------------------------------------- the train step

STEP_SIZE = 128  # at 32 px D's last instance norm normalises 1x1 planes


def _step_configs(dtype):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=STEP_SIZE, filter_size=8,
                                     specseg_base_filters=4, d_input_noise=0.0,
                                     d_dropout=0.0, compute_dtype=dtype)
    jcfg.train = dataclasses.replace(jcfg.train, batch_size=2, g_lr=2e-5, d_lr=2e-5)
    jcfg.data = dataclasses.replace(jcfg.data, flip=False)
    cfg = Config()
    for section in ("model", "train", "data", "eval"):
        for f in dataclasses.fields(getattr(cfg, section)):
            setattr(getattr(cfg, section), f.name, getattr(getattr(jcfg, section), f.name))
    return jcfg, cfg


@pytest.fixture(scope="module")
def steps():
    """One JAX step and one port step at each dtype, from one state (the
    parameters are f32 at both dtypes) and one batch."""
    jcfg, _ = _step_configs("float32")
    shapes = jax.eval_shape(lambda: j_create_train_state(jcfg, jax.random.PRNGKey(0)))
    # seeded parameters; the optimizer state of a fresh state is all zeros
    state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state = state.replace(
        g_params=_redraw(shapes.g_params, 81),
        d_params=jax.tree_util.tree_map(lambda a: 0.5 * a, _redraw(shapes.d_params, 82)),
        specseg_vars=_redraw(shapes.specseg_vars, 83))
    views = np.random.default_rng(84).random((5, 2, STEP_SIZE, STEP_SIZE, 3), np.float32)

    def jax_side(d):
        step = jax.jit(j_make_train_step(_step_configs(d)[0], debug_grads=True))
        _, m = _run_jax(step, state, jnp.asarray(views), jax.random.PRNGKey(42),
                        jnp.zeros((), jnp.int32))
        return m

    jax_out = {d: jax_side(d) for d in DTYPES}

    def port_side(d):
        cfg = _step_configs(d)[1]
        gen, disc, specseg = build_models(cfg, device="cpu")
        load_flax(gen, state.g_params)
        load_flax(disc, state.d_params)
        load_flax(specseg, state.specseg_vars["params"], state.specseg_vars["batch_stats"])
        tstate = create_train_state(cfg, (gen, disc, specseg))
        jm = jax_out[d]
        draws = Draws(flip=torch.tensor(False), t=_t(np.asarray(jm["target_label"])),
                      drop=_t(np.asarray(jm["_drop"])))
        tstate, m = make_train_step(cfg, debug_grads=True)(tstate, _t(views), draws, 0)
        m["_grads"] = {"G": to_flax(tstate.gen, state.g_params, m["_grads"]["G"]),
                       "D": to_flax(tstate.disc, state.d_params, m["_grads"]["D"])}
        return m

    return jax_out, {d: port_side(d) for d in DTYPES}


@pytest.mark.parametrize("net", ["G", "D"])
def test_step_gradients_gap_rule(steps, net):
    """Each network's gradients as one vector. G's conv biases (every bias but
    instance norm's beta) are held apart: the gradient of a bias is the sum of
    a bf16 cotangent over every pixel (163,840 terms for the head), which
    XLA's CPU backend accumulates in bf16, where the sum stagnates (JAX's bf16
    head-bias gradient is 53 % off its f32 value) while oneDNN accumulates in
    f32 (the port's is 0.15 % off). So on those leaves JAX's bf16 is no
    yardstick: they take the gap rule's upper bounds, and the port's bf16
    gradient must lie within 4 d_jax of the rest of G from JAX's f32 one."""
    jax_out, port_out = steps
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jax_out["float32"]["_grads"][net])[0]]
    leaves = {d: {f"{side} {d}": jax.tree_util.tree_leaves(out[d]["_grads"][net])
                  for side, out in (("port", port_out), ("jax", jax_out))}
              for d in DTYPES}
    assert all(len(v) == len(paths) for d in DTYPES for v in leaves[d].values())
    bias = [i for i, p in enumerate(paths)
            if p.endswith("['bias']") and "inorm" not in p] if net == "G" else []

    def pick(idx):
        return ({d: [leaves[d][f"port {d}"][i] for i in idx] for d in DTYPES},
                {d: [leaves[d][f"jax {d}"][i] for i in idx] for d in DTYPES})

    rest = [i for i in range(len(paths)) if i not in bias]
    d_jax = _gap_rule(f"{net} gradients" + (", conv biases apart" if bias else ""), *pick(rest))
    if bias:
        port, jax_ = pick(bias)
        _gap_rule(f"{net} conv-bias gradients", port, jax_, lower=False)
        pb, jf = (np.concatenate([_f64(a).ravel() for a in o])
                  for o in (port["bfloat16"], jax_["float32"]))
        d_f32 = np.linalg.norm(pb - jf) / np.linalg.norm(jf)
        msg = (f"{net} conv-bias gradients: ||port bf16 - jax f32|| = {d_f32:.3e}, "
               f"{d_f32 / d_jax:.3f} d_jax of the rest of {net}")
        print(msg)
        assert d_f32 <= 4.0 * d_jax, msg


STEP_LOSSES = ["total_G", "total_D", "total_C", "G_gan", "G_clsf", "D1_rf", "D3_rf_cyc",
               "D2_rf_target", "D4_rf_cyc", "D1_cls", "D3_cls", "D4_cls", "L1", "SSIM_loss",
               "Spec", "NST", "content", "style", "ssim_mean"]


def test_step_reports_every_loss(steps):
    jax_out, port_out = steps
    for d in DTYPES:
        keys = {k for k in jax_out[d] if not k.startswith("_")}
        assert keys == {k for k in port_out[d] if not k.startswith("_")}
        assert keys == set(STEP_LOSSES) | {"target_label"}


@pytest.mark.parametrize("key", STEP_LOSSES)
def test_step_loss_gap_rule(steps, key):
    """Each loss to the upper bounds. The lower bound, which shows the port
    computing in bf16, is held over all losses together (each scaled by its
    JAX f32 value) in test_step_losses_together: a single scalar's gap is one
    draw of a sum of rounding errors, which can cancel by chance (G_clsf, the
    sum of two classification losses, lands at 0.014 d_jax)."""
    jax_out, port_out = steps
    _gap_rule(key, {d: port_out[d][key] for d in DTYPES}, {d: jax_out[d][key] for d in DTYPES},
              lower=False)


def test_step_losses_together(steps):
    jax_out, port_out = steps
    scale = {k: abs(float(jax_out["float32"][k])) for k in STEP_LOSSES}
    scaled = lambda out: [float(out[k]) / scale[k] for k in STEP_LOSSES]  # noqa: E731
    _gap_rule("every loss", {d: scaled(port_out[d]) for d in DTYPES},
              {d: scaled(jax_out[d]) for d in DTYPES})
