"""The port's class-based transform zoo (``data/pil_augment.py``) against the
JAX package's: every class on the same inputs under generators of the same
seed, outputs bit-equal (tolerance 0: the same numpy arithmetic), ``repr``
equal; and the one deviation, ``Compose`` (and the two list transforms) on a
``TypeError`` raised inside a transform, pinned on both sides."""

import numpy as np
import pytest

from mi_based_regularized_semi_supervised_segmentation_tpu.data import pil_augment as jpa
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import pil_augment as pa

SEEDS = range(8)


def _inputs(seed):
    rng = np.random.default_rng(100 + seed)
    return {
        "grey": rng.random((37, 29), dtype=np.float32),
        "uint8": rng.integers(0, 256, (31, 40), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (23, 26, 3), dtype=np.uint8),
        "channels": rng.random((30, 34, 2), dtype=np.float32),
        "label": rng.integers(0, 5, (33, 27)).astype(np.int32),
    }


# (class name, constructor arguments (built for each package), inputs)
CASES = [
    ("Identity", lambda m: (), ("grey", "label")),
    ("Img2Tensor", lambda m: (), ("grey", "uint8")),
    ("Img2Tensor", lambda m: dict(include_rgb=True, include_grey=True), ("rgb",)),
    ("Img2Tensor", lambda m: dict(include_rgb=True, include_grey=False), ("rgb",)),
    ("PILCutout", lambda m: (4, 9), ("grey", "rgb", "label")),
    ("RandomCrop", lambda m: (16,), ("grey", "rgb", "label")),
    ("RandomCrop", lambda m: dict(size=(20, 12), padding=3), ("grey", "channels")),
    ("RandomCrop", lambda m: dict(size=48, pad_if_needed=True, fill=2), ("grey", "label")),
    ("RandomCrop", lambda m: dict(size=(40, 44), padding=(1, 2, 3, 4), pad_if_needed=True,
                                  padding_mode="reflect"), ("grey", "uint8")),
    ("RandomCrop", lambda m: dict(size=24, padding=(2, 5), padding_mode="edge"), ("rgb",)),
    ("RandomCrop", lambda m: dict(size=24, padding=2, padding_mode="symmetric"), ("grey",)),
    ("CenterCrop", lambda m: (17,), ("grey", "rgb")),
    ("CenterCrop", lambda m: ((12, 25),), ("label",)),
    ("Resize", lambda m: (20,), ("grey", "rgb")),
    ("Resize", lambda m: ((50, 17),), ("grey", "channels")),
    ("Resize", lambda m: (19, "nearest"), ("label", "uint8")),
    ("RandomRotation", lambda m: (30,), ("grey", "rgb", "label")),
    ("RandomRotation", lambda m: ((-90, 10),), ("channels",)),
    ("RandomHorizontalFlip", lambda m: (), ("grey", "rgb")),
    ("RandomVerticalFlip", lambda m: (0.7,), ("grey", "label")),
    ("SobelProcess", lambda m: (), ("grey", "channels")),
    ("SobelProcess", lambda m: (True,), ("grey", "rgb")),
    ("RandomApplyList", lambda m: ([m.RandomRotation(20), m.RandomHorizontalFlip(),
                                    m.CenterCrop(15)], 0.6), ("grey", "rgb")),
    ("RandomChoiceList", lambda m: ([m.RandomVerticalFlip(1.0), m.PILCutout(2, 5),
                                     m.Resize(11), m.ToTensor()],), ("grey", "label")),
    ("Compose", lambda m: ([m.RandomCrop(20, padding=2), m.RandomRotation(15),
                            m.RandomHorizontalFlip(), m.SobelProcess(include_origin=True),
                            m.ToTensor()],), ("grey", "uint8")),
    ("Compose", lambda m: ([m.Resize(16, "nearest"), m.ToLabel({1: 3, 3: 0})],), ("label",)),
    ("ToTensor", lambda m: (), ("grey", "uint8", "rgb")),
    ("ToLabel", lambda m: (), ("label", "uint8")),
    ("ToLabel", lambda m: ({0: 4, 2: 9},), ("label",)),
]


def _build(module, name, make):
    args = make(module)
    return (getattr(module, name)(**args) if isinstance(args, dict)
            else getattr(module, name)(*args))


@pytest.mark.parametrize("name,make,kinds", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_transform_matches_jax(name, make, kinds):
    ours, theirs = _build(pa, name, make), _build(jpa, name, make)
    assert repr(ours) == repr(theirs)
    for seed in SEEDS:
        inputs = _inputs(seed)
        for kind in kinds:
            a = ours(inputs[kind], rng=np.random.default_rng(seed))
            b = theirs(inputs[kind], rng=np.random.default_rng(seed))
            assert a.dtype == b.dtype and a.shape == b.shape, (kind, seed)
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} seed {seed}")


def test_every_public_name_has_a_counterpart():
    assert sorted(pa.__all__) == sorted(jpa.__all__)
    classes = {n for n, v in vars(jpa).items() if isinstance(v, type) and not n.startswith("_")
               and v.__module__ == jpa.__name__}
    assert classes <= set(pa.__all__)
    tested = {c[0] for c in CASES} | {"RandomTransforms"}
    assert tested == set(jpa.__all__)


def test_random_transforms_base_raises_on_both_sides():
    for m in (pa, jpa):
        base = m.RandomTransforms([m.Identity()])
        assert repr(base) == "RandomTransforms(Identity)"
        with pytest.raises(NotImplementedError):
            base(np.zeros((2, 2)))


def test_callables_without_rng_run_on_both_sides():
    """A plain function (no ``rng`` parameter) in each list transform: called
    without ``rng`` on both sides, with the same result."""
    arr = _inputs(0)["grey"]
    for m in (pa, jpa):
        double = lambda a: a * 2  # noqa: E731
        out = m.Compose([double, m.RandomHorizontalFlip(1.0)])(arr, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(out, (arr * 2)[:, ::-1])
        out = m.RandomApplyList([double], p=1.0)(arr, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(out, arr * 2)
        out = m.RandomChoiceList([double])(arr, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(out, arr * 2)


class _RaisesTypeError:
    """Takes ``rng`` and raises ``TypeError`` from inside when it gets one."""

    def __init__(self):
        self.rngs = []

    def __call__(self, arr, rng=None):
        self.rngs.append(rng)
        if rng is not None:
            raise TypeError("raised inside the transform")
        return arr + 1


@pytest.mark.parametrize("wrapper", ["Compose", "RandomApplyList", "RandomChoiceList"])
def test_type_error_inside_a_transform(wrapper):
    """Deviation. The JAX package swallows the ``TypeError`` and calls the
    transform again without ``rng`` (so it draws from the unseeded module
    generator); the port lets it propagate."""
    arr = np.zeros((3, 3), np.float32)
    make = {"Compose": lambda m, t: m.Compose([t]),
            "RandomApplyList": lambda m, t: m.RandomApplyList([t], p=1.0),
            "RandomChoiceList": lambda m, t: m.RandomChoiceList([t])}[wrapper]
    g = np.random.default_rng(0)
    theirs = _RaisesTypeError()
    np.testing.assert_array_equal(make(jpa, theirs)(arr, rng=g), arr + 1)
    assert theirs.rngs == [g, None]
    ours = _RaisesTypeError()
    with pytest.raises(TypeError, match="raised inside the transform"):
        make(pa, ours)(arr, rng=g)
    assert ours.rngs == [g]
