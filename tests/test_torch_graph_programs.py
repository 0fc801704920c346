"""The port's compiled eval, pretrain and mean-teacher programs
(``engine/graphs.py``) on the CPU, where each captured body runs eagerly,
and on the card (marked ``cuda``).

Off a card ``jit=True`` builds the eager programs, so each test wraps the
eager builder (``jit=False``) the way the builder does on a card
(``graphs.GraphStep``, ``graphs.calls``, ``graphs.epoch_scan``): the batch
copied into static buffers, one graph for each layout and static value,
the outputs cloned. Held bit for bit against the eager builder:
- the eval step over patients of two padded lengths (host path and store
  path), called in turn: ``loss``, ``inter``, ``union``, ``pred``;
- the eval scan over P = 3 patients, twice;
- the four pretrain steps over 3 steps and an epoch's short last batch
  (``n_valid`` below the batch: its own graph): metrics, parameters, BN
  statistics, the step counter and (mean-teacher finetune) the teacher and
  its device count;
- the ``meanteacher`` step over 5 steps, on the host path and as a
  device-data scan chunk: metrics, the student's and the teacher's
  parameters and statistics;
- the EMA rate read from a device count (``steps.ema_rate``) equal to the
  np.float32 value the step computed on the host, for t in 0..10^5;
- ``graph_unmet``: None for ``meanteacher`` (under Adam and under the optax
  chain RAdam), a reason for Ranger and for W > 1; the pretrain trainer's
  phases eager off a card.
The eager builders are held against the JAX package by
tests/test_torch_pretrain.py, test_torch_device_data.py, test_torch_ops.py
and test_torch_zoo.py (the mean teacher's device EMA).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    graphs,
    pretrain,
    steps,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (
    build_optimizer,
    init_optimizer_state,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
    build_epoch_scan,
    build_eval_scan,
    build_eval_step,
    build_train_step,
    capture_unmet,
    ema_rate,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.trainer import (
    graph_unmet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ClusterHead,
    LocalClusterHead,
    LocalProjectionHead,
    ProjectionHead,
    UNET_DIMENSIONS,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import DistContext
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP, B, C = 16, 4, 4  # C: the ACDC classes of the synthetic store
LENGTHS = (8, 16)  # two padded patient lengths
EVAL_VALID = (5, 11)
PHASES = ("encoder", "decoder", "finetune", "finetune_mt")
STEPS = (4, 4, 4, 3)  # n_valid of each step: 3 full batches, then an epoch's short last one
MT_STEPS = 5
CARD = torch.device("cuda")


def _equal(got, want, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{what}: {k}")


def _state(*modules) -> dict:
    out = {}
    for i, m in enumerate(modules):
        out.update({f"{i}.{k}": v.detach().clone() for k, v in m.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc_graph_programs"))
    generate_synthetic_acdc(root, num_train_patients=4, num_val_patients=3,
                            slices_per_patient=4, size=2 * CROP)
    return {split: DeviceDataStore(ACDCDataset(root, split)) for split in ("train", "val")}


# --- eval -------------------------------------------------------------------

def _eval_model(device="cpu"):
    torch.manual_seed(0)
    model = UNet(1, C).to(device)
    return model


def _patients(rng, device="cpu"):
    """One host-path eval batch a padded length: image, target, mask."""
    out = []
    for n, valid in zip(LENGTHS, EVAL_VALID):
        out.append((torch.from_numpy(rng.random((n, CROP, CROP, 1), np.float32)).to(device),
                    torch.from_numpy(rng.integers(0, C, (n, CROP, CROP)).astype(np.int32))
                    .to(device),
                    torch.from_numpy(np.arange(n) < valid).to(device)))
    return out


def test_eval_step_graph_body_equals_eager():
    model = _eval_model()
    eager = build_eval_step(model, num_classes=C, jit=False)
    graphed = graphs.calls(eager, ("image", "target", "mask"), "cpu")
    patients = _patients(np.random.default_rng(0))
    for i, inputs in enumerate(patients + patients[::-1] + patients):
        _equal(graphed(*inputs), eager(*inputs), f"call {i}")
    # one graph (here: one static batch) a padded length
    assert sorted(k[0][0][1][0] for k in graphed.graphs.graphs) == sorted(LENGTHS)


def test_eval_step_store_graph_body_equals_eager(stores):
    store = stores["val"]
    model = _eval_model()
    eager = build_eval_step(model, num_classes=C, data_store=store, crop=CROP, jit=False)
    graphed = graphs.calls(eager, ("indices", "mask"), "cpu")
    rng = np.random.default_rng(1)
    calls = [(torch.from_numpy(rng.integers(0, len(store), n).astype(np.int32)),
              torch.from_numpy(np.arange(n) < v)) for n, v in zip(LENGTHS, EVAL_VALID)]
    for i, (idx, mask) in enumerate(calls + calls):
        _equal(graphed(idx, mask), eager(idx, mask), f"call {i}")
    assert len(graphed.graphs.graphs) == len(LENGTHS)


def test_eval_scan_graph_body_equals_eager(stores):
    store = stores["val"]
    model = _eval_model()
    eager = build_eval_scan(model, num_classes=C, data_store=store, crop=CROP, jit=False)
    graphed = graphs.calls(eager, ("indices", "masks"), "cpu")
    rng = np.random.default_rng(2)
    indices = torch.from_numpy(rng.integers(0, len(store), (3, 8)).astype(np.int32))
    masks = torch.from_numpy(np.arange(8)[None] < np.array([[8], [5], [3]]))
    for i in range(2):
        got = graphed(indices, masks)
        assert got["loss"].shape == (3,) and got["inter"].shape == (3, C)
        _equal(got, eager(indices, masks), f"call {i}")
    assert len(graphed.graphs.graphs) == 1  # one graph a split


# --- pretrain ---------------------------------------------------------------

def _pretrain_setup(phase: str, device="cpu", graph: bool = False):
    """The phase's model, heads, _Phase and eager step (crop 16, 4 slices a
    view, the pretrain heads at a small width) from seed 0."""
    torch.manual_seed(0)
    model = UNet(1, C).to(device)
    teacher = None
    if phase == "encoder":
        heads = {"projector": ProjectionHead(UNET_DIMENSIONS["Conv5"], output_dim=16,
                                             interm_dim=16),
                 "iic": ClusterHead(UNET_DIMENSIONS["Conv5"], num_clusters=4, num_subheads=2)}
        comps = pretrain.component_range("Conv1", "Conv5")
    elif phase == "decoder":
        heads = {"projector": LocalProjectionHead(UNET_DIMENSIONS["Up_conv3"]),
                 "iic": LocalClusterHead(UNET_DIMENSIONS["Up_conv3"], num_clusters=5,
                                         num_subheads=2, head_type="mlp", flat_output=False)}
        comps = pretrain.component_range("Up5", "Up_conv3")
    else:
        heads, comps = {}, pretrain.COMPONENT_NAMES
        if phase == "finetune_mt":
            teacher = copy.deepcopy(model).requires_grad_(False)
    ph = pretrain._Phase(model, nn.ModuleDict(heads).to(device), comps, 1e-3, 1e-5,
                         torch.device(device), 11, teacher, graph=graph)
    kw = dict(step_counter=ph.counter, jit=False)
    if phase == "encoder":
        step = pretrain.build_pretrain_encoder_step(model, ph.heads["projector"], ph.optimizer,
                                                    iic_head=ph.heads["iic"], **kw)
    elif phase == "decoder":
        step = pretrain.build_pretrain_decoder_step(model, ph.heads["projector"], ph.optimizer,
                                                    generator=ph.generator,
                                                    iic_head=ph.heads["iic"], **kw)
    elif phase == "finetune":
        step = pretrain.build_finetune_step(model, ph.optimizer, num_classes=C, **kw)
    else:
        step = pretrain.build_finetune_mt_step(model, teacher, ph.optimizer, num_classes=C,
                                               generator=ph.generator, ema_count=ph.ema_count,
                                               **kw)
    return model, ph, step


def _pretrain_batches(phase: str, device="cpu"):
    """(batch, static keywords) of each step: the short last batch repeats
    its last real row, as the trainer pads it."""
    rng = np.random.default_rng(5)
    out = []
    for n_valid in STEPS:
        image = rng.random((B, CROP, CROP, 1), np.float32)
        image[n_valid:] = image[n_valid - 1]
        batch = {"image": image}
        static = {"n_valid": n_valid}
        if phase in ("encoder", "decoder"):
            batch["image_tf"] = rng.random((B, CROP, CROP, 1), np.float32)
            parts, groups = ["0", "1", "2", "0"], ["p1", "p1", "p2", "p2"]
            batch["labels"] = (pretrain.global_labels(parts, groups) if phase == "encoder" else
                               pretrain.local_labels(parts, groups,
                                                     pretrain.unfold_locations((4, 4), B)))
        else:
            batch["target"] = rng.integers(0, C, (B, CROP, CROP)).astype(np.int32)
        if phase == "finetune_mt":
            batch["unlabeled_image"] = rng.random((B + 2, CROP, CROP, 1), np.float32)
            static["n_unlabeled_valid"] = B + 2 if n_valid == B else B
        out.append(({k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()},
                    static))
    return out


def _pretrain_run(phase: str, graphed: bool, device="cpu"):
    # one optimizer for both runs: on the card built for a graph
    model, ph, step = _pretrain_setup(phase, device, graph=device != "cpu")
    program = graphs.GraphStep(step) if graphed else step
    metrics = [program(batch, **static) for batch, static in _pretrain_batches(phase, device)]
    modules = [model, ph.heads] + ([ph.teacher] if ph.teacher is not None else [])
    out = {"metrics": metrics, "state": _state(*modules), "step": int(ph.counter),
           "program": program}
    if ph.ema_count is not None:
        out["ema_count"] = int(ph.ema_count)
    ph.close()
    return out


@pytest.mark.parametrize("phase", PHASES)
def test_pretrain_graph_body_equals_eager(phase):
    got, want = _pretrain_run(phase, True), _pretrain_run(phase, False)
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        _equal(g, w, f"{phase} step {i}")
    _equal(got["state"], want["state"], f"{phase} state")
    assert got["step"] == want["step"] == len(STEPS)
    assert got.get("ema_count") == want.get("ema_count")
    if phase == "finetune_mt":
        assert got["ema_count"] == len(STEPS)
    # one graph for the full batch, one for the short last batch
    assert len(got["program"].graphs) == 2
    graphs.release(got["program"])
    assert not got["program"].graphs


def test_pretrain_phase_state_round_trip():
    """A phase's checkpoint holds lr as a float and loads into the
    optimizer's, the counter's and the teacher's count's own tensors."""
    model, ph, step = _pretrain_setup("finetune_mt")
    for batch, static in _pretrain_batches("finetune_mt")[:2]:
        step(batch, **static)
    state = copy.deepcopy(ph.state_dict())
    assert all(type(g["lr"]) is float for g in state["optimizer"]["param_groups"])
    model2, ph2, _ = _pretrain_setup("finetune_mt")
    moments = [st["exp_avg"] for st in ph2.optimizer.state.values()]
    count = ph2.ema_count
    ph2.load_state_dict(state)
    assert [st["exp_avg"] for st in ph2.optimizer.state.values()] == moments  # same tensors
    assert ph2.ema_count is count and int(count) == int(ph2.counter) == 2
    _equal(_state(model2, ph2.teacher), _state(model, ph.teacher), "loaded")


# --- the mean teacher -------------------------------------------------------

def _mt_setup(device="cpu", store=None, graph: bool = False):
    torch.manual_seed(0)
    model = UNet(1, C).to(device)
    teacher = copy.deepcopy(model).requires_grad_(False)
    opt = build_optimizer(model.parameters(), {"name": "Adam", "lr": 1e-3,
                                               "weight_decay": 1e-4}, graph=graph)
    init_optimizer_state(opt)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    step = build_train_step(model, opt, "meanteacher", num_classes=C, generator=gen,
                            teacher=teacher, reg_weight=10.0, ema_alpha=0.99,
                            data_store=store, crop=CROP, geometry="shear", jit=False)
    return model, teacher, step


def _mt_batches(device="cpu"):
    rng = np.random.default_rng(7)
    return [{"labeled_image": torch.from_numpy(rng.random((2, CROP, CROP, 1), np.float32)),
             "labeled_target": torch.from_numpy(rng.integers(0, C, (2, CROP, CROP))
                                                .astype(np.int32)),
             "unlabeled_image": torch.from_numpy(rng.random((3, CROP, CROP, 1), np.float32))}
            for _ in range(MT_STEPS)]


def test_meanteacher_graph_body_equals_eager():
    runs = {}
    for graphed in (True, False):
        model, teacher, step = _mt_setup()
        program = graphs.GraphStep(step) if graphed else step
        metrics = [program(b) for b in _mt_batches()]
        runs[graphed] = (metrics, _state(model, teacher), int(step.step_counter))
    (got, state_g, steps_g), (want, state_e, steps_e) = runs[True], runs[False]
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"step {i}")
    _equal(state_g, state_e, "student and teacher")
    assert steps_g == steps_e == MT_STEPS


def test_meanteacher_scan_graph_body_equals_eager(stores):
    store = stores["train"]
    rng = np.random.default_rng(8)
    chunks = [{"labeled_indices": torch.from_numpy(rng.integers(0, len(store), (n, 2))),
               "unlabeled_indices": torch.from_numpy(rng.integers(0, len(store), (n, 3)))}
              for n in (3, 2)]
    runs = {}
    for graphed in (True, False):
        model, teacher, step = _mt_setup(store=store)
        fn = graphs.epoch_scan(step, 3) if graphed else build_epoch_scan(step, 3, jit=False)
        outs = [fn(c) for c in chunks]
        runs[graphed] = (outs, _state(model, teacher))
    (got, state_g), (want, state_e) = runs[True], runs[False]
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"chunk {i}")
    _equal(state_g, state_e, "student and teacher")


@pytest.mark.parametrize("alpha", [0.999, 0.99])
def test_ema_rate_from_device_count_equals_host_value(alpha):
    """a = min(1 - 1 / (t + 1), alpha) in fp32 from an int64 count, bit for
    bit the np.float32 scalar the step took from the host count."""
    t = np.arange(100_001)
    tf = t.astype(np.float32)
    want = np.minimum(np.float32(1.0) - np.float32(1.0) / (tf + np.float32(1.0)),
                      np.float32(alpha))
    got = ema_rate(torch.from_numpy(t), alpha)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for step in (0, 1, 7, 999, 100_000):  # the scalar form, one count at a time
        scalar = min(np.float32(1.0) - np.float32(1.0) / (np.float32(step) + np.float32(1.0)),
                     np.float32(alpha))
        assert ema_rate(torch.tensor(step), alpha).item() == scalar


def test_graph_unmet_covers_meanteacher():
    cfg = {"Trainer": {"name": "meanteacher"}, "Optim": {"name": "Adam", "lr": 1e-3}}
    assert graph_unmet(cfg, CARD) is None
    assert graph_unmet(cfg, CARD, DistContext()) is None
    radam = {**cfg, "Optim": {"name": "RAdam", "lr": 1e-3}}
    assert graph_unmet(radam, CARD) is None  # the optax chains are captured too
    ranger = {**cfg, "Optim": {"name": "Ranger", "lr": 1e-3}}
    assert "Ranger" in graph_unmet(ranger, CARD)
    assert "process group" in graph_unmet(cfg, CARD, DistContext(world=2))
    assert "card" in graph_unmet(cfg, torch.device("cpu"))
    # the eval programs: no optimizer, so only the CPU and a group keep them eager
    assert capture_unmet(CARD) is None
    assert capture_unmet(CARD, None, DistContext(world=2)) is not None


def test_eval_builder_refuses_a_group_on_card():
    """An eval program asked for as a graph under a process group raises
    before anything touches a card (gloo's collectives cannot be
    captured)."""
    model = _eval_model()
    with pytest.raises(ValueError, match="jit=False"):
        steps._eval_graphed(CARD, DistContext(world=2), True)
    assert not steps._eval_graphed(CARD, DistContext(world=2), False)
    # off a card jit=True is the eager function, the group's sums included
    assert not hasattr(build_eval_step(model, num_classes=C, context=DistContext(world=2)),
                       "graphs")


# --- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("phase", PHASES)
def test_pretrain_graph_against_eager_on_card(phase, monkeypatch):
    """Each pretrain step on the card, graph (the builder's, jit=True)
    against eager (jit=False) from the same weights and seed, one
    graph-built Adam for both, under cuDNN's deterministic algorithms:
    metrics and state bit for bit; the decoder's 3 joint launches counted
    once a step."""
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for graphed in (False, True):
        model, ph, step = _pretrain_setup(phase, "cuda", graph=True)
        if graphed:
            step = graphs.GraphStep(step)
        mi_joint.reset_launch_counts()
        metrics = [{k: v.cpu() for k, v in step(b, **s).items()}
                   for b, s in _pretrain_batches(phase, "cuda")]
        launches = sum(mi_joint.LAUNCHES.values())
        modules = [model, ph.heads] + ([ph.teacher] if ph.teacher is not None else [])
        runs[graphed] = (metrics, {k: v.cpu() for k, v in _state(*modules).items()}, launches)
        graphs.release(step)
        ph.close()
    (got, state_g, n_g), (want, state_e, n_e) = runs[True], runs[False]
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"{phase} step {i}")
    _equal(state_g, state_e, phase)
    assert n_g == n_e == (3 * len(STEPS) if phase == "decoder" else 0)


@pytest.mark.cuda
def test_eval_and_meanteacher_graph_against_eager_on_card(monkeypatch):
    """The eval step (two lengths), the eval scan and the meanteacher step on
    the card: jit=True against jit=False, bit for bit under deterministic
    cuDNN."""
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = _eval_model("cuda")
    eager = build_eval_step(model, num_classes=C, jit=False)
    graphed = build_eval_step(model, num_classes=C)
    patients = _patients(np.random.default_rng(0), "cuda")
    for i, inputs in enumerate(patients * 3):
        _equal(graphed(*inputs), eager(*inputs), f"eval call {i}")
    assert graphed.graphs.captured
    runs = {}
    for jit in (False, True):
        model, teacher, step = _mt_setup("cuda", graph=True)
        program = graphs.GraphStep(step) if jit else step
        metrics = [{k: v.cpu() for k, v in program({k: v.cuda() for k, v in b.items()}).items()}
                   for b in _mt_batches()]
        runs[jit] = (metrics, {k: v.cpu() for k, v in _state(model, teacher).items()})
    for i, (g, w) in enumerate(zip(runs[True][0], runs[False][0])):
        _equal(g, w, f"meanteacher step {i}")
    _equal(runs[True][1], runs[False][1], "meanteacher state")


def test_graph_step_refuses_an_injected_draw():
    """A captured step's tensors come in its batch: a flip mask passed as a
    keyword (which a graph would bake in) raises, naming jit=False."""
    _, ph, step = _pretrain_setup("decoder")
    batch, static = _pretrain_batches("decoder")[0]
    with pytest.raises(TypeError, match="jit=False"):
        graphs.GraphStep(step)(batch, flip_mask=torch.zeros((B, 2), dtype=torch.bool), **static)
    ph.close()
