"""The port's CUDA-graph step and scans (``engine/graphs.py``) on the CPU,
where each captured body runs eagerly, and on the card (marked ``cuda``).

- The three scans' captured bodies, run eagerly over a chunk of 3 steps and
  a shorter one of 2 (the epoch's last), with their device counter and
  metric rows, equal the eager loops (``jit=False``) bit for bit: stacked
  metrics, parameters, BN statistics, the global step. The eager loops are
  held against the JAX package's ``build_epoch_scan*`` by
  tests/test_torch_epoch_scan.py.
- ``graph_unmet``: None for every covered configuration (the headline, the
  mean teacher and the optax chains RAdam and AdaBound among them), a
  reason for each one that stays eager (the CPU, a process group,
  Lookahead / Ranger); a step asked to be captured raises where its
  optimizer was not built for a graph.
- ``build_optimizer`` builds for a graph only when asked (``graph=True``;
  the pretrain phases and every other caller keep a float lr), and refuses
  the lookahead chains for one (the optax chains built for a graph:
  tests/test_torch_graph_optim.py).
- Adam, AdamW and SGD built for a graph (a tensor lr that
  ``set_learning_rate`` fills) against the float-lr optimizers over 5 steps
  with an lr change: within 4 fp32 ulps of each parameter, or 1e-6 of a
  step's size (lr) near zero (the tensor holds lr rounded to fp32, which
  torch's step multiplies in fp32 where a float lr enters in double); the
  checkpoint form of the state (lr a float) and its load, into the
  optimizer's own tensors (lr and state).
- The launch bookkeeping: a capture's counts leave the counters, and each
  replay adds them back once.
- On the card: the headline step at a small size, graph against eager from
  the same weights and generator seed, losses (against the eager-to-eager
  floor), flip draws and launches; each optax chain's step captured against
  its eager step, bit for bit.
"""

from itertools import chain

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import graphs
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (
    build_optimizer,
    capture_unmet,
    init_optimizer_state,
    load_optimizer_state,
    optimizer_state_dict,
    set_learning_rate,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
    TrainStep,
    _fold_in,
    augment_from_store,
    build_augment_fn,
    build_epoch_scan,
    build_epoch_scan_pipelined,
    build_epoch_scan_preaug,
    build_train_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.trainer import (
    graph_unmet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import (
    launches,
    mi_fused,
    mi_joint,
    rotate,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import DistContext
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

FEATS = ("Conv5", "Up_conv3", "Up_conv2")
CROP, BL, BU, C, S, K = 32, 2, 3, 4, 2, 5
LR, WD = 1e-3, 1e-4
COMMON = dict(num_classes=C, feature_names=FEATS, feature_importance=(1.0, 0.5, 0.5),
              uda_criterion="mse", uda_weight=10.0, iic_weight=0.1, reg_weight=1.0,
              paddings=[1, 1], patch_sizes=1024)
CHUNKS = (3, 2)  # a chunk of scan_chunk = 3 steps, then the epoch's shorter last one


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc_graph"))
    generate_synthetic_acdc(root, num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return DeviceDataStore(ACDCDataset(root, "train"), pack=True)


def _fresh(device="cpu", optim="Adam", graph=False):
    torch.manual_seed(0)
    model = UNet(1, C).to(device)
    proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S).to(device)
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": optim, "lr": LR, "weight_decay": WD, "momentum": 0.9},
                          graph=graph)
    init_optimizer_state(opt)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    return model, proj, opt, gen


def _step(model, proj, opt, gen, store, jit=False, backend="plain"):
    return build_train_step(model, opt, "udaiic", generator=gen, projector=proj,
                            backend=backend, data_store=store, crop=CROP, geometry="shear",
                            jit=jit, **COMMON)


def _chunks(seed=0):
    rng = np.random.default_rng(seed)
    return [{"labeled_indices": torch.from_numpy(rng.integers(0, 24, (n, BL))),
             "unlabeled_indices": torch.from_numpy(rng.integers(0, 24, (n, BU)))}
            for n in CHUNKS]


def _scan(loop, step, store, size, graphed):
    """The loop's chunk function: the captured body (``graphs``, run
    eagerly here) for chunks up to ``size``, or the eager loop of ``size``."""
    aug = build_augment_fn(store, crop=CROP, geometry="shear")
    if loop == "plain":
        return (graphs.epoch_scan(step, size) if graphed
                else build_epoch_scan(step, size, jit=False))
    if loop == "pipelined":
        return (graphs.epoch_scan_pipelined(step, size, aug.draw, _fold_in) if graphed
                else build_epoch_scan_pipelined(aug, step, size, jit=False))

    def augment():
        lab_img, lab_tgt = augment_from_store(store, None, CROP, "shear", step.generator)
        unl_img, _ = augment_from_store(store, None, CROP, "shear", step.generator,
                                        with_labels=False)
        return {"labeled_image": lab_img, "labeled_target": lab_tgt, "unlabeled_image": unl_img}

    return (graphs.epoch_scan_preaug(step, size, augment) if graphed
            else build_epoch_scan_preaug(step, store, size, crop=CROP, geometry="shear",
                                         generator=step.generator, jit=False))


@pytest.mark.parametrize("loop", ["plain", "pipelined", "preaug"])
def test_captured_scan_body_equals_eager_loop(store, loop):
    runs = {}
    for graphed in (True, False):
        model, proj, opt, gen = _fresh()
        step = _step(model, proj, opt, gen, store if loop == "plain" else None)
        assert isinstance(step, TrainStep)  # the CPU: eager whatever jit says
        outs = []
        if graphed:  # one body for both chunks
            fn = _scan(loop, step, store, max(CHUNKS), graphed)
        for i, batches in enumerate(_chunks()):
            if not graphed:  # the eager loop is built for each chunk's size
                fn = _scan(loop, step, store, len(batches["labeled_indices"]), graphed)
            outs.append(fn(batches, 11 + i) if loop == "pipelined" else fn(batches))
            if graphed:  # the device counter went once round the chunk's rows
                assert int(fn.chunks.counter) == len(batches["labeled_indices"])
        runs[graphed] = (outs, model.state_dict(), proj.state_dict(), int(step.step_counter))
    (got, model_g, proj_g, steps_g), (want, model_e, proj_e, steps_e) = runs[True], runs[False]
    assert steps_g == steps_e == sum(CHUNKS)
    for chunk_g, chunk_e, n in zip(got, want, CHUNKS):
        assert set(chunk_g) == set(chunk_e)
        for key, stacked in chunk_g.items():
            assert stacked.shape[0] == n
            torch.testing.assert_close(stacked, chunk_e[key], rtol=0, atol=0, msg=key)
    for got_sd, want_sd in ((model_g, model_e), (proj_g, proj_e)):
        for name, value in got_sd.items():
            torch.testing.assert_close(value, want_sd[name], rtol=0, atol=0, msg=name)


def _cfg(optim="Adam"):
    return {"Trainer": {"name": "udaiic"}, "Optim": {"name": optim, "lr": 1e-3}}


CARD = torch.device("cuda")


@pytest.mark.parametrize("mode", ["udaiic", "meanteacher"])
@pytest.mark.parametrize("world", [None, 1])
@pytest.mark.parametrize("optim", ["Adam", "AdamW", "SGD", "RAdam", "AdaBound"])
def test_graph_unmet_none_for_covered(optim, world, mode):
    """The mean teacher is covered: its EMA reads the step count on the
    card (``steps.ema_rate``), so the trainer's teacher is no reason; so
    are the optax chains, whose count and scalars live on the card."""
    ctx = None if world is None else DistContext()
    cfg = _cfg(optim)
    cfg["Trainer"]["name"] = mode
    assert graph_unmet(cfg, CARD, ctx) is None


@pytest.mark.parametrize("case", ["cpu", "Lookahead", "Ranger", "data_parallel", "space_split"])
def test_graph_unmet_reason_for_eager(case):
    cfg, device, ctx = _cfg(), CARD, None
    if case == "cpu":
        device = torch.device("cpu")
    elif case in ("Lookahead", "Ranger"):
        cfg = _cfg(case)
    else:
        ctx = DistContext(world=2, space_size=2 if case == "space_split" else 1)
    reason = graph_unmet(cfg, device, ctx)
    assert isinstance(reason, str) and reason
    if case in ("Lookahead", "Ranger"):  # the same reason from the built optimizer
        params = [torch.nn.Parameter(torch.zeros(3))]
        assert capture_unmet(build_optimizer(params, cfg["Optim"])) == reason
        with pytest.raises(ValueError, match="CUDA graph"):
            build_optimizer(params, cfg["Optim"], graph=True)


def _optim_run(name, graph):
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(257)), torch.nn.Parameter(torch.randn(4, 31))]
    opt = build_optimizer(params, {"name": name, "lr": 1e-2, "weight_decay": 1e-3,
                                   "momentum": 0.9}, graph=graph)
    init_optimizer_state(opt)
    for t in range(5):
        if t == 3:
            set_learning_rate(opt, 4e-3)
        for p in params:
            p.grad = torch.sin(p.detach() * (t + 1)) + 0.1 * p.detach()
        opt.step()
    return opt, [p.detach().clone() for p in params]


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_tensor_lr_optimizers_equal_float_lr(name):
    opt, got = _optim_run(name, graph=True)
    plain, want = _optim_run(name, graph=False)
    assert type(plain.param_groups[0]["lr"]) is float  # what every caller but a graph gets
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and float(lr) == np.float32(4e-3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=4 * 2.0 ** -23, atol=1e-6 * 1e-2)
    # on the CPU nothing is captured: torch's flags stay off
    assert capture_unmet(opt) is not None
    # a checkpoint holds lr as a float; loading keeps the optimizer's tensor
    state = optimizer_state_dict(opt)
    assert all(type(g["lr"]) is float for g in state["param_groups"])
    set_learning_rate(opt, 1.0)
    def state_ids():
        return [id(t) for st in opt.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]

    before = state_ids()
    load_optimizer_state(opt, state)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(4e-3)
    # into the optimizer's own state tensors, which a captured step reads
    assert before and state_ids() == before


def test_captured_launches_added_once_a_replay():
    for module in (mi_joint, mi_fused, rotate):
        module.reset_launch_counts()
    mi_joint.LAUNCHES[("before", 1)] += 2
    with launches.captured() as record:
        mi_joint.LAUNCHES[("mi_joint_fwd", 3)] += 1
        mi_joint.LAUNCHES[("before", 1)] += 1
        mi_fused.LAUNCHES[("mi_fused_fwd", 1)] += 2
        rotate.LAUNCHES[(rotate.ROTATE, 4)] += 1
    # the capture launched nothing: the counters are as they were
    assert dict(mi_joint.LAUNCHES) == {("before", 1): 2}
    assert not mi_fused.LAUNCHES and not rotate.LAUNCHES
    for _ in range(7):
        record.replayed()
    assert dict(mi_joint.LAUNCHES) == {("before", 1): 9, ("mi_joint_fwd", 3): 7}
    assert dict(mi_fused.LAUNCHES) == {("mi_fused_fwd", 1): 14}
    assert dict(rotate.LAUNCHES) == {(rotate.ROTATE, 4): 7}
    mi_joint.reset_launch_counts()  # the same counters, cleared in place
    for _ in range(3):
        record.replayed()
    assert dict(mi_joint.LAUNCHES) == {("before", 1): 3, ("mi_joint_fwd", 3): 3}
    for module in (mi_joint, mi_fused, rotate):
        module.reset_launch_counts()


def test_graph_step_raises_where_not_captured():
    """A step that cannot be captured, asked for with jit=True on a card,
    raises; the check runs before anything touches a card."""
    model, proj, opt, gen = _fresh()
    step = _step(model, proj, opt, gen, None)
    step.device = CARD  # as if on a card: the optimizer was not built for a graph
    with pytest.raises(ValueError, match=r"graph=True.*jit=False"):
        build_epoch_scan(step, 2)


# --- on the card ------------------------------------------------------------

def _card_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"labeled_image": torch.from_numpy(rng.random((BL, CROP, CROP, 1), np.float32)),
             "labeled_target": torch.from_numpy(rng.integers(0, C, (BL, CROP, CROP))
                                                .astype(np.int32)),
             "unlabeled_image": torch.from_numpy(rng.random((BU, CROP, CROP, 1), np.float32))}
            for _ in range(n)]


@pytest.mark.cuda
def test_graph_step_against_eager_on_card(monkeypatch):
    """The small udaiic step on the card, 6 steps from the same weights and
    generator seed and one optimizer built for a graph, run eager, graph (2
    eager warm-up steps, the capture, 4 replays), eager, under cuDNN's
    deterministic algorithms (by default two eager runs part by ~1e-3 of the
    total loss over 6 steps, cuDNN's weight gradients summing in another
    order): each loss of the graph run within 1e-5 of the step's total loss
    from the first eager run's, or within twice the second eager run's
    difference where that is larger; the flip masks of the replayed steps bit
    for bit; 6 joint launches a step in each run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import steps

    batches = _card_batches(6)
    runs = []
    draw = steps.sample_flip_mask
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for jit in (False, True, False):
        masks = []
        monkeypatch.setattr(steps, "sample_flip_mask",
                            lambda *a, **k: masks.append(draw(*a, **k)) or masks[-1])
        model, proj, opt, gen = _fresh("cuda", graph=True)  # one optimizer for both steps
        step = _step(model, proj, opt, gen, None, jit=jit, backend="auto")
        assert isinstance(step, graphs.GraphStep) == jit
        mi_joint.reset_launch_counts()
        losses, drawn = [], []
        for b in batches:
            metrics = step({k: v.cuda() for k, v in b.items()})
            drawn.append(masks[-1].clone())  # under replay the graph's own mask
            losses.append({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi",
                                                         "total_loss")})
        runs.append((losses, drawn, sum(mi_joint.LAUNCHES.values())))
    (eager, eager_masks, _), (graph, graph_masks, _), (eager2, _, _) = runs
    assert [n for _, _, n in runs] == [6 * len(batches)] * 3

    def gap(a, b):
        return max(abs(y[k] - x[k]) / abs(x["total_loss"]) for x, y in zip(a, b) for k in x)

    assert gap(eager, graph) <= max(1e-5, 2 * gap(eager, eager2)), (eager, graph, eager2)
    for e, g in zip(eager_masks, graph_masks):
        assert torch.equal(e, g)


CHAINS = ("RAdam", "NAdam", "Adadelta", "Adagrad", "Adamax", "RMSprop", "Rprop", "AdaBound",
          "AdaBelief", "Yogi", "NovoGrad", "Lamb", "Lion")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CHAINS)
def test_captured_chain_step_equals_eager_on_card(name):
    """Each optax chain built for a graph on the card, its step captured
    (``graphs.Graphed``: 2 eager warm-up steps, the capture, replays) on
    static gradients, against the same optimizer's eager step, 8 steps (past
    RAdam's switch at 6) with the lr changed after step 2, weight decay on:
    parameters and state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    shapes = ((4, 3), (3,), (2, 3, 3, 3))
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes] for _ in range(8)]
    runs = []
    for captured in (False, True):
        params = [torch.nn.Parameter(p.cuda()) for p in p0]
        opt = build_optimizer(params, {"name": name, "lr": 1e-2, "weight_decay": 1e-2,
                                       "momentum": 0.9}, graph=True)
        init_optimizer_state(opt)
        assert capture_unmet(opt) is None
        for p in params:
            p.grad = torch.zeros_like(p)
        step = graphs.Graphed(opt.step, CARD) if captured else opt.step
        for i, g in enumerate(grads):
            if i == 2:
                set_learning_rate(opt, 3e-3)
            for p, gi in zip(params, g):
                p.grad.copy_(gi)
            step()
        torch.cuda.synchronize()
        assert not captured or step.captured
        runs.append(([p.detach().cpu() for p in params],
                     [{k: v.cpu() for k, v in opt.state[p].items()} for p in params]))
    (p_e, s_e), (p_g, s_g) = runs
    for a, b in zip(p_g, p_e):
        assert torch.equal(a, b)
    for a, b in zip(s_g, s_e):
        for key in b:
            assert torch.equal(a[key], b[key]), key
