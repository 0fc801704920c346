"""The port's model zoo (``models/zoo.py``, ``models/vgg.py``) against the
JAX package's flax modules, through ``weights.py``: every registered family
and VGG11 / ClassifyHead, from the same flax variables (shapes from
``jax.eval_shape``, values from numpy: kernels at 1 / sqrt(fan-in), random
biases, BN affine parameters and running statistics, PReLU slopes) and the
same numpy inputs: B = 2 at 32^2, volumes [2, 1, 8, 32, 32]; the DeepLabs
(``test_torch_arch_zoo_deeplab.py``) at their default depth.

The reference is the JAX module computed in float64 (``jax.enable_x64``;
its heads stay fp32 as flax writes them): at B = 2 and 32^2 the U-Nets'
bottom BN normalises 8 values a channel, and fp32 gradients of either side
sit up to 2.9e-2 of their largest entry from float64 (the Attention U-Net;
ENet's 2.3e-3 at a PReLU slope), so fp32 JAX is no tight yardstick. Held,
each within its ``TOL_*`` of the reference's largest entry (readings on
this CPU in brackets):
- the port in fp32: eval forward (9e-7), train forward (2.5e-5), the BN
  running statistics it moves (1.6e-5), and the gradients of a fixed loss
  sum(out * R) (2.9e-2; a detached or missing path reads ~1);
- the port in float64 against the same reference: train forward (2e-7) and
  every gradient (5.6e-7), a gradient that is zero by construction (a
  convolution bias before train-mode BN) against 1e-9 of the model's
  largest gradient;
- the weight map loads strictly: every port parameter and buffer has its
  flax leaf, name for name.
ENet's dropout draws are the JAX side's masks replaced through
``flax.linen.intercept_methods`` by masks drawn here, which the port's
``Dropout.draw`` returns too. A bf16 forward (``dtype`` = ``bn_dtype`` =
bfloat16 on both sides, eval) checks the output dtypes and holds the port's
output by relative L2 distances (``check_bf16_forward``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mi_based_regularized_semi_supervised_segmentation_tpu.models import zoo as jzoo
from mi_based_regularized_semi_supervised_segmentation_tpu.models.vgg import (
    ClassifyHead as JClassifyHead,
    VGG11 as JVGG11,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ARCH_CALLABLES,
    ClassifyHead,
    UNet,
    VGG11,
    get_arch,
    zoo,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    arch_state_dict,
    zoo_state_dict,
)

# of the float64 reference's largest entry (see the module docstring)
TOL_EVAL, TOL_TRAIN, TOL_STATS, TOL_GRAD32 = 1e-5, 2e-4, 2e-4, 0.1
TOL_64 = 1e-5
ACDC = {"input_dim": 1, "num_classes": 4}
FAMILIES = {  # registered name: (kwargs, input NHWC / NDHWC)
    "enet": (ACDC, (2, 32, 32, 1)),
    "attention_unet": (ACDC, (2, 32, 32, 1)),
    "vnet": (ACDC, (2, 8, 32, 32, 1)),
    "deeplabv2": (ACDC, (2, 32, 32, 1)),
    "deeplabv3": (ACDC, (2, 32, 32, 1)),
    "deeplabv3plus": (ACDC, (2, 32, 32, 1)),
    "densenet3d": ({"input_dim": 1, "num_classes": 2}, (2, 8, 32, 32, 1)),
}


@pytest.fixture(autouse=True)
def _restore_threads():
    """Some tests here take two intra-op threads; the tests after them (in
    this process, other files too) get the count back."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def _to_port(x):
    """NHWC / NDHWC -> NCHW / NCDHW."""
    return np.moveaxis(x, -1, 1)


def _to_jax(x):
    return np.moveaxis(x, 1, -1)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _variables(jmodel, shape, seed=0):
    """flax variables of ``jmodel`` (shapes by ``jax.eval_shape``, values from
    numpy): kernels at 1 / sqrt(fan-in), biases, BN scale / bias / running
    statistics and PReLU slopes all random, so that each is exercised."""
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                                  train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shp = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0, 1 / np.sqrt(np.prod(shp[:-1])), shp)
        elif name in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, shp)
        elif name == "negative_slope":
            value = rng.uniform(0.0, 0.3, shp)
        else:  # bias, mean
            value = rng.normal(0, 0.1, shp)
        return np.asarray(value, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, abstract)
    return variables["params"], variables.get("batch_stats", {})


def _jax_model(arch, kw, dtype=jnp.float32):
    extra = {"dtype": dtype} if arch == "vnet" else {"dtype": dtype, "bn_dtype": dtype}
    return jzoo.ARCH_CALLABLES[arch](**kw, **extra)


def _port_model(arch, kw, params, stats, dtype=torch.float32):
    extra = {"dtype": dtype} if arch == "vnet" else {"dtype": dtype, "bn_dtype": dtype}
    model = get_arch(arch, dict(kw, arch=arch, **extra))
    model.load_state_dict(arch_state_dict(arch, params, stats), strict=True)
    return model


class _Masks:
    """Dropout keep masks drawn here, one per flax Dropout path: the JAX
    side's interceptor and the port's ``Dropout.draw`` both take them."""

    def __init__(self, seed=3):
        self.rng, self.masks = np.random.default_rng(seed), {}

    def get(self, path, shape, rate):
        if path not in self.masks:
            self.masks[path] = self.rng.random(shape) >= rate
        return self.masks[path]

    def interceptor(self, next_fun, args, kwargs, context):
        module = context.module
        if not (isinstance(module, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = jnp.asarray(self.get(".".join(module.path), x.shape, module.rate))
        return jnp.where(keep, x / (1.0 - module.rate), jnp.zeros_like(x))

    def install(self, model):
        for name, m in model.named_modules():
            if isinstance(m, zoo.Dropout):
                m.draw = lambda x, name=name: torch.from_numpy(_to_port(self.masks[name]).copy())


def test_registry_names_and_unknown():
    assert sorted(ARCH_CALLABLES) == sorted(jzoo.ARCH_CALLABLES)
    for name in ("ContrastUnet", "unet", "UNET"):
        assert isinstance(get_arch(name, {"arch": name, "num_classes": 3}), UNet)
    for name, (kw, _) in FAMILIES.items():
        assert type(get_arch(name.upper(), kw)).__name__ == type(_jax_model(name, kw)).__name__
    slopes = [m.weight for m in get_arch("vnet", {}).modules() if isinstance(m, zoo.PReLU)]
    assert len(slopes) == 6 + 15 and all(w.shape == (1,) and w.item() == np.float32(0.01)
                                         for w in slopes)  # flax's init; torch's is 0.25
    with pytest.raises(KeyError, match="not found"):
        get_arch("segformer", {})
    with pytest.raises(AssertionError):
        jzoo.get_arch("segformer", {})


def _reference(arch, kw, params, stats, x, masks, rng):
    """The JAX module in float64: eval output, and train output, moved BN
    statistics and gradients of sum(out * R) with R drawn from ``rng``."""
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True):
        jmodel = _jax_model(arch, kw, jnp.float64)
        p, s, xj = f64(params), f64(stats), jnp.asarray(x, jnp.float64)
        evaluate = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x,
                                                        train=False))
        out_eval = np.asarray(evaluate(p, s, xj), np.float64)
        r = rng.normal(size=out_eval.shape)

        def loss(p, s, x):
            with fnn.intercept_methods(masks.interceptor):
                out, mutated = jmodel.apply({"params": p, "batch_stats": s}, x, train=True,
                                            mutable=["batch_stats"])
            return jnp.sum(out * r), (out, mutated["batch_stats"])

        (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(p, s, xj)
        out, new_stats, grads = jax.device_get((out, new_stats, grads))
    return out_eval, r, np.asarray(out, np.float64), new_stats, grads


def _nchw(a):
    return torch.from_numpy(_to_port(a).copy()) if a.ndim > 2 else torch.from_numpy(a)


def _nhwc(t):
    a = t.detach().double().numpy()
    return _to_jax(a) if a.ndim > 2 else a


def _check_grads(model, want_grads, tol, floor, what):
    """Each gradient within ``tol`` of its largest reference entry, or of
    ``floor`` times the model's largest gradient where that is more (a
    gradient that is zero by construction reads the other gradients'
    rounding noise)."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads and all(g is not None for g in grads.values()), what
    floor *= max(float(np.abs(want_grads[n].numpy()).max()) for n in grads)
    for name, g in grads.items():
        want = want_grads[name].numpy().astype(np.float64)
        err = np.abs(g.double().numpy() - want).max()
        scale = max(np.abs(want).max(), floor)
        assert err <= tol * scale, f"{what} grad {name}: {err:.3e} of {scale:.3e}"


def check_family(arch, kw, shape):
    torch.set_num_threads(2)
    jmodel = _jax_model(arch, kw)
    params, stats = _variables(jmodel, shape)
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    masks = _Masks()
    out_eval, r, out_train, new_stats, grads = _reference(arch, kw, params, stats, x, masks, rng)
    want_stats = arch_state_dict(arch, params, new_stats)
    want_grads = arch_state_dict(arch, grads, stats)

    model = _port_model(arch, kw, params, stats).eval()
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32
    _close(_nhwc(got), out_eval, TOL_EVAL, "eval")
    model.train()
    masks.install(model)
    got = model(_nchw(x))
    (got.double() * _nchw(r)).sum().backward()
    assert (arch == "enet") == bool(masks.masks)
    _close(_nhwc(got), out_train, TOL_TRAIN, "train")
    for name, value in model.state_dict().items():
        if "running_" in name:
            _close(value.numpy(), want_stats[name].numpy(), TOL_STATS, name)
    _check_grads(model, want_grads, TOL_GRAD32, 1e-5, "fp32")

    model64 = _port_model(arch, kw, params, stats, torch.float64).double().train()
    masks.install(model64)
    got = model64(_nchw(x).double())
    (got.double() * _nchw(r)).sum().backward()
    _close(_nhwc(got), out_train, TOL_64, "train, float64")
    _check_grads(model64, want_grads, TOL_64, 1e-9, "float64")


ZOO_2D3D = ("enet", "attention_unet", "vnet", "densenet3d")


@pytest.mark.parametrize("arch", ZOO_2D3D)
def test_family_matches_jax(arch):
    check_family(arch, *FAMILIES[arch])


def _l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_bf16_forward(arch, kw, shape):
    """dtype = bn_dtype = bfloat16 on both sides, eval mode: fp32 logits;
    the port's bf16 output as far from the JAX fp32 one as a bf16 forward
    is (at least a quarter of the JAX bf16 output's relative L2 distance
    from it: a dtype ignored reads ~1e-6), and within twice that distance
    of the JAX bf16 output (two bf16 computations that round in other
    orders: readings 0.24-1.29 of it)."""
    torch.set_num_threads(2)
    jmodel32, jmodel16 = _jax_model(arch, kw), _jax_model(arch, kw, jnp.bfloat16)
    params, stats = _variables(jmodel32, shape)
    model = _port_model(arch, kw, params, stats, torch.bfloat16).eval()
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want32, want16 = (jax.jit(lambda v, x, m=m: m.apply(v, x, train=False))(variables,
                                                                            jnp.asarray(x))
                      for m in (jmodel32, jmodel16))
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32 and want16.dtype == jnp.float32
    got, want16, want32 = _nhwc(got), np.asarray(want16, np.float64), np.asarray(want32)
    assert np.isfinite(got).all()
    bf16_gap = _l2(want16, want32)
    assert _l2(got, want32) >= 0.25 * bf16_gap, (_l2(got, want32), bf16_gap)
    assert _l2(got, want16) <= 2 * bf16_gap, (_l2(got, want16), bf16_gap)


@pytest.mark.parametrize("arch", ZOO_2D3D)
def test_family_bf16_forward(arch):
    check_bf16_forward(arch, *FAMILIES[arch])


def test_bf16_mixed_dtypes_promote_as_flax():
    """ENet with bf16 compute and fp32 BN keeps an fp32 residual stream and
    a bf16 branch, as flax does; the logits come back fp32."""
    model = zoo.ENet(1, 4, dtype=torch.bfloat16, bn_dtype=torch.float32).eval()
    seen = {}
    model.b1_1.register_forward_hook(lambda m, i, o: seen.update(out=o.dtype))
    model.b1_1.proj_out.register_forward_hook(lambda m, i, o: seen.update(branch=o.dtype))
    with torch.no_grad():
        out = model(torch.zeros(2, 1, 32, 32))
    assert seen == {"out": torch.float32, "branch": torch.bfloat16}
    assert out.dtype == torch.float32


def test_vgg11_and_classify_head_match_jax():
    torch.set_num_threads(2)
    shape = (2, 32, 32, 1)
    jvgg, jhead = JVGG11(input_dim=1), JClassifyHead(num_classes=4, interm_dim=16)
    params, stats = _variables(jvgg, shape)
    hparams = jax.device_get(jhead.init(jax.random.PRNGKey(2), jnp.zeros((1, 512))))["params"]
    vgg, head = VGG11(1), ClassifyHead(512, 4, 16)
    vgg.load_state_dict(zoo_state_dict(params, stats), strict=True)
    head.load_state_dict(zoo_state_dict(hparams), strict=True)
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(_to_port(x).copy())
    for train in (False, True):
        feats, mutated = jax.jit(lambda v, x, train=train: jvgg.apply(
            v, x, train=train, mutable=["batch_stats"]))({"params": params, "batch_stats": stats},
                                                         jnp.asarray(x))
        proj, logits = jhead.apply({"params": hparams}, feats)
        vgg.train(train)
        with torch.no_grad():
            got_feats = vgg(xt)
            got_proj, got_logits = head(got_feats)
        tol = TOL_TRAIN if train else TOL_EVAL
        _close(got_feats.numpy(), feats, tol, f"features, train={train}")
        _close(got_proj.numpy(), proj, tol, "projection")
        _close(got_logits.numpy(), logits, tol, "logits")
    new_sd = zoo_state_dict(params, jax.device_get(mutated["batch_stats"]))
    for name, value in vgg.state_dict().items():
        if "running_" in name:
            _close(value.numpy(), new_sd[name].numpy(), TOL_STATS, name)


def test_conv_transpose_needs_the_flipped_kernel():
    """flax's ConvTranspose does not flip its kernel: the map flips it, and
    the unflipped kernel would give another function."""
    rng = np.random.default_rng(8)
    jconv = fnn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2))
    x = rng.normal(size=(1, 3, 4, 5, 2)).astype(np.float32)
    params = jax.device_get(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    conv = zoo.ConvTranspose3d(2, 3, 2)
    mapped = _strip(zoo_state_dict({"up": params}, transposed=("up",)), "up.")
    k = np.asarray(params["kernel"])  # [k, k, k, in, out] -> [in, out, k, k, k], unflipped
    unflipped = dict(mapped, weight=torch.from_numpy(np.transpose(k, (3, 4, 0, 1, 2)).copy()))
    for sd, close in ((mapped, True), (unflipped, False)):
        conv.load_state_dict(sd)
        with torch.no_grad():
            got = _to_jax(conv(torch.from_numpy(_to_port(x).copy())).numpy())
        assert np.allclose(got, want, rtol=1e-5, atol=1e-6) == close


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_resize_and_same_padding_edges_match_jax():
    """``jax.image.resize`` nearest x2 and bilinear upsampling (edges
    included) against F.interpolate; flax's strided "SAME" padding on odd
    and even sizes."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    xt = torch.from_numpy(_to_port(x).copy())
    for mode, size in (("nearest", (10, 14)), ("bilinear", (40, 56)), ("bilinear", (9, 13))):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), method=mode))
        got = _to_jax(zoo._resize(xt, size, mode).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{mode} {size}")
    for n in (7, 8):
        v = rng.normal(size=(1, n, n, n, 2)).astype(np.float32)
        jconv = fnn.Conv(4, (2, 2, 2), strides=(2, 2, 2))
        params = jax.device_get(jconv.init(jax.random.PRNGKey(1), jnp.asarray(v)))["params"]
        want = np.asarray(jconv.apply({"params": params}, jnp.asarray(v)))
        conv = zoo.Conv3d(2, 4, 2, 2)
        conv.load_state_dict(_strip(zoo_state_dict({"c": params}), "c."))
        with torch.no_grad():
            got = _to_jax(conv(zoo._flax_same(torch.from_numpy(_to_port(v).copy()), 2, 2))
                          .numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"n={n}")
