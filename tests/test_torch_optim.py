"""The port's optimizer namespace (``engine/optim.py``) against the JAX
package's optax transforms, and the trainers under a non-Adam ``Optim.name``.

Each of the 18 ``OPTIMIZERS`` names steps the same parameters with the same
numpy gradients (a tenth of the entries zero, one tensor starting at zero)
for ``STEPS`` steps on both sides, the learning rate changed between steps 2
and 3 (``set_learning_rate`` on both). Held: every parameter after every
step within ``TOL`` of the largest move of its tensor from the start. Read
on this CPU: 0 (bit for bit) for 8 of the optax-ordered names (NAdam,
Adadelta, Adamax, Rprop, AdaBelief, Yogi, Lion, Lookahead), up to 1.2e-5 for
the others but RAdam and Ranger; up to 1.5e-5 for torch's Adam / AdamW /
SGD (another summation order); up to 3.5e-5 for RAdam and Ranger, whose
rectification term at t = 6 is ill-conditioned in fp32 (rho_t 5.975 against
5.994 in float64; r moves 0.6% for each 0.02 of rho_t). b^t itself is the
same on both sides over these steps (scripts/torch_pow_rounding.py).

``Lookahead`` / ``Ranger`` are held against ``optax.lookahead`` on
``LookaheadParams`` (fast and slow weights); the trainers refuse them.
One udaiic step under SGD (momentum, nesterov) and under RAdam is held
against the JAX step with the step tests' bounds (``test_torch_step.py``),
and a resume under SGD and RAdam restores the optimizer bit for bit, as one
under RAdam and AdaBound built for a graph does, from its own checkpoint and
from a plain one (the graph-built chains: test_torch_graph_optim.py).
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    OPTIMIZERS as J_OPTIMIZERS,
    ConstantScheduler as JConstantScheduler,
    RampScheduler as JRampScheduler,
    build_optimizer as j_build_optimizer,
    set_learning_rate as j_set_learning_rate,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    OPTIMIZERS,
    ConstantScheduler,
    RampScheduler,
    build_optimizer,
    checkpoints,
    init_optimizer_state,
    set_learning_rate,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    trainer as trainer_module,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (
    OptaxOptimizer,
)
from test_torch_checkpoints import CROP, _assert_same, _one_step, make_config, make_loaders
from test_torch_step import _check_losses, _check_params, _run_both
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

SHAPES = {"w": (4, 3), "b": (3,), "k": (2, 3, 3, 3)}
STEPS = 8            # past Lookahead's sync at 5, Ranger's at 6, RAdam's rectification at 6
LR, LR2 = 1e-2, 3e-3
TOL = 5e-5           # of the largest move of each tensor (see the docstring)
LOOKAHEAD = ("Lookahead", "Ranger")
NAMES = ("Adam", "AdamW", "SGD", "RAdam", "NAdam", "Adadelta", "Adagrad", "Adamax", "RMSprop",
         "Rprop", "AdaBound", "AdaBelief", "Yogi", "NovoGrad", "Lamb", "Lion") + LOOKAHEAD
CASES = [dict(name=n, weight_decay=wd) for n in NAMES for wd in (0.0, 1e-2)] + [
    dict(name="SGD", momentum=0.9, weight_decay=1e-2),
    dict(name="SGD", momentum=0.9, nesterov=True),
    dict(name="SGD", momentum=0.0, nesterov=True),   # no trace: nesterov has no effect
    dict(name="RMSprop", momentum=0.9, centered=True, weight_decay=1e-2),
    dict(name="RMSprop", momentum=0.9),
    dict(name="AdaBound", gamma=1.0),                # a band narrow enough to clip
    dict(name="Adagrad", initial_accumulator_value=0.1),
    dict(name="RAdam", b2=0.99, eps=1e-6),
]


def _case_id(case):
    return "-".join(f"{k}={v}" if k != "name" else v for k, v in case.items())


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    params["b"][:] = 0  # a zero tensor: Lamb's trust ratio is 1 there
    grads = [{k: (rng.normal(size=s) * (rng.random(s) > 0.1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def test_every_jax_name_is_ported():
    assert set(OPTIMIZERS) == set(J_OPTIMIZERS) and len(OPTIMIZERS) == 18


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_optimizer_matches_optax(case):
    cfg = dict(case, lr=LR)
    lookahead = case["name"] in LOOKAHEAD
    p0, grads = _problem()
    tx = j_build_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    if lookahead:
        jparams = optax.LookaheadParams.init_synced(jparams)
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.tensor(p0[k])) for k in SHAPES]
    opt = build_optimizer(params, cfg)
    init_optimizer_state(opt)
    for i in range(STEPS):
        if i == 2:
            jstate = j_set_learning_rate(jstate, LR2)
            set_learning_rate(opt, LR2)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads[i].items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(params, SHAPES):
            p.grad = torch.tensor(grads[i][k])
        opt.step()
        held = [(p.detach(), jparams.fast if lookahead else jparams) for p in params]
        if lookahead:  # the slow weights, in the optimizer's state
            held += [(opt.state[p]["slow"], jparams.slow) for p in params]
        for (got, tree), k in zip(held, list(SHAPES) * 2):
            want = np.asarray(tree[k])
            moved = np.abs(want - p0[k]).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= TOL * moved, f"step {i + 1}, {k}: {err:.3e} of a {moved:.3e} move"


def test_rprop_first_update_is_zero():
    """optax's Rprop applies the previous step's sign update: the first is
    -lr * 0 for every entry, whatever the gradient."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    opt = build_optimizer([p], {"name": "Rprop", "lr": 0.1})
    p.grad = torch.tensor([0.5, -0.5, 0.0])
    opt.step()
    assert torch.equal(p.detach(), torch.tensor([1.0, -2.0, 3.0]))
    p.grad = torch.tensor([0.5, -0.5, 0.0])
    opt.step()  # now the first step's sign update, at step size 1 times lr
    np.testing.assert_allclose(p.detach().numpy(), [0.9, -1.9, 3.0], rtol=1e-7)


def test_build_optimizer_keeps_the_jax_surface():
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = build_optimizer(p, {})  # name Adam, lr 1e-3
    assert type(opt) is torch.optim.Adam and opt.param_groups[0]["lr"] == 1e-3
    with pytest.raises(KeyError, match=r"'Adagrad', 'Adam', 'AdamW'"):
        build_optimizer(p, {"name": "adam"})
    with pytest.raises(KeyError):
        j_build_optimizer({"name": "adam"})
    # every key reaches the factory as float(v); keys it does not take are dropped
    opt = build_optimizer(p, {"name": "SGD", "lr": "0.5", "momentum": "0.9", "nesterov": True,
                              "dampening": 0.3, "betas": 7})
    group = opt.param_groups[0]
    assert (group["lr"], group["momentum"], group["nesterov"], group["dampening"]) == (
        0.5, 0.9, True, 0)
    opt = build_optimizer(p, {"name": "RMSprop", "centered": True, "rho": 3})
    assert opt.param_groups[0]["centered"] == 1.0 and "rho" not in opt.param_groups[0]
    with pytest.raises(ValueError):
        build_optimizer(p, {"name": "SGD", "momentum": "heavy"})


@pytest.mark.parametrize("name", NAMES)
def test_state_exists_at_init_and_reloads(name):
    """Every optimizer's state exists before its first step (optax's
    ``tx.init``), so an unstepped trainer's checkpoint holds every entry; a
    state_dict loaded into a fresh optimizer steps bit for bit as the one
    that wrote it."""
    cfg = {"name": name, "lr": LR, "weight_decay": 1e-2, "momentum": 0.9}
    p0, grads = _problem(1)

    def build():
        params = [torch.nn.Parameter(torch.tensor(p0[k])) for k in SHAPES]
        opt = build_optimizer(params, cfg)
        init_optimizer_state(opt)
        return params, opt

    params, opt = build()
    template = opt.state_dict()
    assert len(template["state"]) == len(params)
    assert all(torch.is_tensor(v) for s in template["state"].values() for v in s.values())
    for i in range(3):
        for p, k in zip(params, SHAPES):
            p.grad = torch.tensor(grads[i][k])
        opt.step()
    saved = copy.deepcopy(opt.state_dict())
    assert not checkpoints.mismatches(template, saved)
    params2, opt2 = build()
    with torch.no_grad():
        for a, b in zip(params2, params):
            a.copy_(b)
    opt2.load_state_dict(saved)
    for model, o in ((params, opt), (params2, opt2)):
        for p, k in zip(model, SHAPES):
            p.grad = torch.tensor(grads[3][k])
        o.step()
    _assert_same(opt2.state_dict(), opt.state_dict())
    for a, b in zip(params2, params):
        assert torch.equal(a, b)


def test_optax_optimizers_skip_a_parameter_without_gradient():
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    opt = build_optimizer([a, b], {"name": "Yogi", "lr": 0.1})
    assert isinstance(opt, OptaxOptimizer)
    a.grad = torch.ones(2)
    opt.step()
    assert torch.equal(b.detach(), torch.ones(2)) and int(opt.state[b]["step"]) == 0
    assert int(opt.state[a]["step"]) == 1 and not torch.equal(a.detach(), torch.ones(2))


def test_schedulers_match_jax():
    for args in ((2, 10, 0.0, 1.0), (0, 5, 0.1, 0.7, -3.0), (3, 3, 0.0, 2.0)):
        ours, theirs = RampScheduler(*args), JRampScheduler(*args)
        for _ in range(12):
            assert ours.value == theirs.value
            ours.step()
            theirs.step()
    for args in ((), (3, 0.25)):
        ours, theirs = ConstantScheduler(*args), JConstantScheduler(*args)
        for _ in range(5):
            assert ours.value == theirs.value
            ours.step()
            theirs.step()


@pytest.mark.parametrize("name", LOOKAHEAD)
def test_trainers_refuse_lookahead_before_any_data(name, tmp_path):
    argv = ["Trainer.name=udaiic", "Trainer.device=cpu", f"Trainer.save_dir={tmp_path / 'run'}",
            "Data.synthetic=false", f"Data.root_dir={tmp_path / 'absent'}", f"Optim.name={name}"]
    with pytest.raises(ValueError, match="LookaheadParams"):
        port_main.main(argv)
    assert not (tmp_path / "run").exists()
    with pytest.raises(KeyError, match="unknown optimizer"):
        port_main.main(argv[:-1] + ["Optim.name=Nadam"])
    with pytest.raises(ValueError, match="LookaheadParams"):
        trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None, val_loader=None,
                               test_loader=None, device="cpu", run_dir=str(tmp_path),
                               configuration={"Optim": {"name": name}})


STEP_OPTIMS = {
    "SGD": {"name": "SGD", "lr": 1e-3, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4},
    "RAdam": {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-4},
}


@pytest.mark.parametrize("name", sorted(STEP_OPTIMS))
def test_udaiic_step_matches_jax(name):
    """One udaiic step of the port under ``name`` against the JAX step's,
    with the step tests' bounds (losses rtol 2e-4; parameters with the
    two-tier bound at lr 1e-3; BN statistics rtol 1e-4)."""
    jmetrics, metrics, before, after_jax, after = _run_both(
        "udaiic", "xla", "plain", optim=STEP_OPTIMS[name])
    _check_losses(jmetrics, metrics)
    _check_params(before, after_jax, after)


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_optim_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return make_loaders(root)


RESUME_SGD = {"name": "SGD", "lr": 1e-3, "momentum": 0.9, "weight_decay": 1e-5}
RESUME_RADAM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
RESUME_ADABOUND = {"name": "AdaBound", "lr": 1e-3, "weight_decay": 1e-5}


@pytest.mark.parametrize("optim,graph", [
    (RESUME_SGD, (False, False)), (RESUME_RADAM, (False, False)),
    (RESUME_RADAM, (True, True)), (RESUME_ADABOUND, (True, True)),
    (RESUME_RADAM, (False, True)), (RESUME_ADABOUND, (False, True)),
], ids=["SGD", "RAdam", "RAdam-graph", "AdaBound-graph", "RAdam-cpu_count_into_graph",
        "AdaBound-cpu_count_into_graph"])
def test_resume_restores_the_optimizer_bit_for_bit(loaders, tmp_path, monkeypatch, optim, graph):
    """``graph``: whether the writing and the resumed trainer build their
    optimizer for a CUDA graph (``graph_unmet`` made None on the CPU: lr a
    tensor and one count a group, the step eager as off a card). A plain
    writer's checkpoint holds a CPU count a parameter, as the port wrote it
    before the optax chains were built for a graph; a graph-built reader
    loads it strict and lenient, each tensor and the lr in place."""
    cfg = make_config("udaiic")
    cfg["Optim"] = optim
    unmet = trainer_module.graph_unmet

    def build(save_dir, graphed, max_epoch=1):
        monkeypatch.setattr(trainer_module, "graph_unmet", (lambda *a: None) if graphed else unmet)
        t = trainer_zoos["udaiic"](configuration=json.loads(json.dumps(cfg)), save_dir=save_dir,
                                   max_epoch=max_epoch, num_batches=2, device="cpu",
                                   crop_size=CROP, run_dir=str(tmp_path), **loaders)
        t.init()
        assert getattr(t._optimizer, "graph", graphed) == graphed
        return t

    first = build("run", graph[0])
    assert type(first._optimizer).__name__ == optim["name"]
    first.start_training()
    saved = torch.load(tmp_path / "run" / checkpoints.LAST_NAME, weights_only=True)
    state = saved["optimizer"]["state"]
    assert len(state) == len(list(first._optimizer.param_groups[0]["params"]))
    assert saved["optimizer"]["param_groups"][0]["lr"] == first._optimizer.param_groups[0]["lr"]
    for strict in (True, False) if graph == (False, True) else (True,):
        resumed = build(f"resumed_{strict}", graph[1], max_epoch=2)
        opt = resumed._optimizer
        owned = [id(v) for st in opt.state.values() for v in st.values()]
        lr = opt.param_groups[0]["lr"]
        resumed.load_state_dict_from_path(str(tmp_path / "run"), strict=strict)
        _assert_same(_lr32(resumed.state_dict()),
                     _lr32({k: v for k, v in saved.items() if k != "meta"}))
        if graph[1]:  # into the optimizer's own tensors, which a captured step reads
            assert [id(v) for st in opt.state.values() for v in st.values()] == owned
            assert opt.param_groups[0]["lr"] is lr
        _one_step(resumed)
        stepped = resumed.state_dict()
    _one_step(first)
    _assert_same(_lr32(stepped), _lr32(first.state_dict()))


def _lr32(state):
    """``state`` with the optimizer's lr as its fp32 rounding: what a tensor
    lr holds of a plain checkpoint's float (the step multiplies in fp32
    either way)."""
    groups = [{**g, "lr": float(np.float32(g["lr"]))} for g in state["optimizer"]["param_groups"]]
    return {**state, "optimizer": {**state["optimizer"], "param_groups": groups}}
