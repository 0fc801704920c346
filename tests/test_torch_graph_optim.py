"""The optax-chain optimizers built for a CUDA graph (``build_optimizer(...,
graph=True)``: one count a group and lr as 0-d fp32 tensors on the
parameters' device, the step's scalars computed there with torch ops, the
branches as selects), on the CPU and on the card (marked ``cuda``).

- Each of the 13 ``CHAINS`` (every optax chain the trainers step), built
  for a graph, against optax (the JAX package's ``build_optimizer``) over
  ``STEPS`` steps with the lr changed between steps 2 and 3, within
  ``TOL`` of each tensor's largest move (test_torch_optim's problem and
  bound). Read on this CPU: 0 (bit for bit) for NAdam, Adadelta, Adamax,
  Rprop, AdaBelief, Yogi and Lion; up to 1.5e-6 for Adagrad, RMSprop,
  NovoGrad and Lamb's default; 6.1e-6 for Lamb with decay; 1.2e-5 for
  AdaBound; 2.1e-5 for RAdam (its t = 6 term, test_torch_optim's
  docstring): each reading the plain build's, to the bit.
- The same against the plain build (a CPU count a parameter, the scalars
  handed over as floats): parameters and state bit for bit.
- The branches pinned: RAdam at b2 = 0.999 takes the bias-corrected first
  moment through t = 5 (rho_t 4.996; r NaN at t = 3 and 4, finite at 5) and
  rectifies from t = 6; NovoGrad's first step sets nu to |g|^2 and mu to
  g / (|g| + eps); AdaBound's band [final (1 - 1/(gamma t + 1)), final (1 +
  1/(gamma t))] narrows and clips the step from both sides.
- The capture checks: every name but Lookahead / Ranger builds for a graph;
  ``capture_unmet`` names the CPU for one built there and the lookahead
  chains always.
- Loading: a plain checkpoint (a count a parameter) into a graph-built
  optimizer fills the group's count and every state tensor in place, and a
  graph-built one's (one count a group) into a plain optimizer gives each
  parameter a count of its own.
- A udaiic step under RAdam and AdaBound as ``GraphStep`` (its body run
  eagerly off a card) with the graph-built optimizer, against the eager
  step with the plain one: metrics, parameters and state bit for bit.

On the card (a file without JAX): tests/test_torch_graph.py's
``test_captured_chain_step_equals_eager_on_card``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import graphs
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (
    LOOKAHEAD_NAMES,
    OptaxOptimizer,
    build_optimizer,
    capture_unmet,
    init_optimizer_state,
    load_optimizer_state,
    optimizer_state_dict,
    set_learning_rate,
)
from test_torch_graph import _card_batches, _fresh, _step
from test_torch_optim import CASES, LR, LR2, SHAPES, STEPS, TOL, _case_id, _problem
from test_torch_optim import j_build_optimizer, j_set_learning_rate
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CHAINS = ("RAdam", "NAdam", "Adadelta", "Adagrad", "Adamax", "RMSprop", "Rprop", "AdaBound",
          "AdaBelief", "Yogi", "NovoGrad", "Lamb", "Lion")
CHAIN_CASES = [c for c in CASES if c["name"] in CHAINS]


def _run(case, graph, device="cpu", steps=STEPS, seed=0):
    """The case's optimizer (``graph``: built for one) stepped over the
    problem's gradients, the lr changed after step 2: (optimizer,
    parameters after each step)."""
    p0, grads = _problem(seed)
    params = [torch.nn.Parameter(torch.tensor(p0[k], device=device)) for k in SHAPES]
    opt = build_optimizer(params, dict(case, lr=LR), graph=graph)
    init_optimizer_state(opt)
    after = []
    for i in range(steps):
        if i == 2:
            set_learning_rate(opt, LR2)
        for p, k in zip(params, SHAPES):
            p.grad = torch.tensor(grads[i][k], device=device)
        opt.step()
        after.append([p.detach().cpu().clone() for p in params])
    return opt, after


def test_every_chain_is_covered():
    assert len(CHAINS) == 13 and {c["name"] for c in CHAIN_CASES} == set(CHAINS)


@pytest.mark.parametrize("case", CHAIN_CASES, ids=_case_id)
def test_graph_built_chain_matches_optax(case):
    opt, after = _run(case, graph=True)
    assert isinstance(opt, OptaxOptimizer) and opt.graph
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    p0, grads = _problem()
    tx = j_build_optimizer(dict(case, lr=LR))
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    for i in range(STEPS):
        if i == 2:
            jstate = j_set_learning_rate(jstate, LR2)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads[i].items()}, jstate,
                                    jparams)
        jparams = {k: jparams[k] + updates[k] for k in SHAPES}
        for got, k in zip(after[i], SHAPES):
            want = np.asarray(jparams[k])
            moved = np.abs(want - p0[k]).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= TOL * moved, f"step {i + 1}, {k}: {err:.3e} of a {moved:.3e} move"
    # one count for the group, in every parameter's state, on the parameters' device
    counts = {id(opt.state[p]["step"]) for p in opt.param_groups[0]["params"]}
    assert len(counts) == 1 and float(opt.state[opt.param_groups[0]["params"][0]]["step"]) == STEPS


@pytest.mark.parametrize("case", CHAIN_CASES, ids=_case_id)
def test_graph_built_chain_equals_plain(case):
    graph_opt, got = _run(case, graph=True)
    plain_opt, want = _run(case, graph=False)
    assert not plain_opt.graph and type(plain_opt.param_groups[0]["lr"]) is float
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b, k in zip(g, w, SHAPES):
            assert torch.equal(a, b), f"step {i + 1}, {k}"
    for pg, pp in zip(graph_opt.param_groups[0]["params"], plain_opt.param_groups[0]["params"]):
        sg, sp = graph_opt.state[pg], plain_opt.state[pp]
        assert sg.keys() == sp.keys()
        for key in sg:
            assert torch.equal(sg[key], sp[key]), key


def _scalars(name, t, **hyper):
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = build_optimizer(p, {"name": name, "lr": LR, **hyper}, graph=True)
    group = opt.param_groups[0]
    return opt._scalars(group, torch.tensor(float(t)), group["lr"])


def test_radam_switches_at_rho_five():
    """rho_t at b2 = 0.999 is 4.996 at t = 5 and 5.994 at t = 6 (float64);
    the fp32 count on the device takes the first moment through t = 5 and
    rectifies from t = 6, and r's NaN (t = 3, 4) never reaches an update."""
    rect = {t: bool(_scalars("RAdam", t)["rectified"]) for t in range(1, 9)}
    assert rect == {1: False, 2: False, 3: False, 4: False, 5: False, 6: True, 7: True, 8: True}
    assert all(torch.isnan(_scalars("RAdam", t)["r"]) for t in (3, 4))
    assert torch.isfinite(_scalars("RAdam", 5)["r"])
    # the updates themselves: finite each step, the first moment alone up to t = 5
    p = torch.nn.Parameter(torch.ones(4))
    opt = build_optimizer([p], {"name": "RAdam", "lr": 0.1}, graph=True)
    mu = torch.zeros(4)
    for t in range(1, 8):
        before = p.detach().clone()
        p.grad = torch.tensor([1.0, -2.0, 0.5, 0.0]) * t
        mu = 0.9 * mu + 0.1 * p.grad
        opt.step()
        move = p.detach() - before
        assert torch.isfinite(move).all(), t
        if t <= 5:  # -lr * mu / (1 - b1^t), from the optimizer's own moment
            bc1 = 1 - np.float32(np.float32(0.9) ** np.float64(t))
            want = -0.1 * opt.state[p]["mu"] / torch.tensor(bc1, dtype=torch.float32)
            torch.testing.assert_close(move, want, rtol=1e-6, atol=1e-7, msg=str(t))
        else:  # rectified: smaller than the first moment's own step
            assert (move.abs()[:3] < (0.1 * mu.abs()[:3] / (1 - 0.9 ** t))).all(), t


def test_novograd_first_step_sets_the_moments():
    g = torch.tensor([3.0, -4.0])
    p = torch.nn.Parameter(torch.zeros(2))
    opt = build_optimizer([p], {"name": "NovoGrad", "lr": 0.1}, graph=True)
    p.grad = g.clone()
    opt.step()
    st = opt.state[p]
    assert float(st["nu"]) == 25.0  # |g|^2, not (1 - b2) |g|^2
    eps = 1e-8
    torch.testing.assert_close(st["mu"], g / (5.0 + np.float32(eps)), rtol=0, atol=0)
    torch.testing.assert_close(p.detach(), -0.1 * st["mu"], rtol=0, atol=0)
    s1, s2 = _scalars("NovoGrad", 1), _scalars("NovoGrad", 2)
    assert (float(s1["nu_decay"]), float(s1["nu_weight"]), float(s1["mu_decay"])) == (0, 1, 0)
    assert float(s2["nu_decay"]) == np.float32(0.25) and float(s2["mu_decay"]) == np.float32(0.9)
    p.grad = g.clone()
    opt.step()  # the moments now: nu = b2 nu + (1 - b2) |g|^2 = 25
    assert float(st["nu"]) == 25.0


def test_adabound_band_narrows_and_clips():
    final, gamma = 0.1, 1.0
    band = [_scalars("AdaBound", t, final_lr=final, gamma=gamma) for t in (1, 2, 4, 8)]
    for t, s in zip((1, 2, 4, 8), band):
        assert float(s["lower"]) == pytest.approx(final * (1 - 1 / (gamma * t + 1)), rel=1e-6)
        assert float(s["upper"]) == pytest.approx(final * (1 + 1 / (gamma * t)), rel=1e-6)
    widths = [float(s["upper"] - s["lower"]) for s in band]
    assert widths == sorted(widths, reverse=True)
    # a large gradient clips to the lower edge, a small one to the upper, a middling one not
    p = torch.nn.Parameter(torch.zeros(3))
    opt = build_optimizer([p], {"name": "AdaBound", "lr": 1e-2, "final_lr": final,
                                "gamma": gamma}, graph=True)
    p.grad = torch.tensor([100.0, 1e-3, 1.0])
    opt.step()
    s, mu = band[0], opt.state[p]["mu"]
    eff = -p.detach() / mu
    assert float(eff[0]) == pytest.approx(float(s["lower"]), rel=1e-6)
    assert float(eff[1]) == pytest.approx(float(s["upper"]), rel=1e-6)
    assert float(s["lower"]) < float(eff[2]) < float(s["upper"])


@pytest.mark.parametrize("name", CHAINS + LOOKAHEAD_NAMES)
def test_capture_checks(name):
    params = [torch.nn.Parameter(torch.zeros(3))]
    cfg = {"name": name, "lr": LR}
    if name in LOOKAHEAD_NAMES:
        reason = capture_unmet(name)
        assert "LookaheadParams" in reason
        assert capture_unmet(build_optimizer(params, cfg)) == reason
        with pytest.raises(ValueError, match="CUDA graph"):
            build_optimizer(params, cfg, graph=True)
        return
    assert capture_unmet(name) is None
    # off a card a graph-built chain is named, and a plain one by its float lr
    assert "on the card" in capture_unmet(build_optimizer(params, cfg, graph=True))
    assert "Python float" in capture_unmet(build_optimizer(params, cfg))


def _state_ids(opt):
    return {(i, key): id(v) for i, p in enumerate(opt.param_groups[0]["params"])
            for key, v in opt.state[p].items()}


@pytest.mark.parametrize("name", ["RAdam", "AdaBound", "NovoGrad"])
def test_checkpoint_counts_load_both_ways(name):
    """A plain optimizer's state (a CPU count a parameter, as the port wrote
    it before the chains were built for a graph) loads into a graph-built
    one in place, its count the group's; the reverse gives each parameter
    a count of its own; each then steps bit for bit as the writer."""
    case = {"name": name, "weight_decay": 1e-2}
    for writer, reader in ((False, True), (True, False)):
        src, _ = _run(case, graph=writer, steps=3)
        saved = copy.deepcopy(optimizer_state_dict(src))
        dst, _ = _run(case, graph=reader, steps=1, seed=5)  # other values, one step
        ids = _state_ids(dst)
        lr = dst.param_groups[0]["lr"]
        load_optimizer_state(dst, saved)
        assert _state_ids(dst) == ids, "loaded into the optimizer's own tensors"
        steps = [dst.state[p]["step"] for p in dst.param_groups[0]["params"]]
        assert all(float(s) == 3 for s in steps)
        assert len({id(s) for s in steps}) == (1 if reader else len(steps))
        if reader:
            assert dst.param_groups[0]["lr"] is lr and float(lr) == np.float32(LR2)
        else:
            assert dst.param_groups[0]["lr"] == np.float32(LR2)
        _, grads = _problem()
        with torch.no_grad():  # the same parameters and gradients, one more step
            for p, q in zip(dst.param_groups[0]["params"], src.param_groups[0]["params"]):
                p.copy_(q)
        for opt in (src, dst):
            for p, k in zip(opt.param_groups[0]["params"], SHAPES):
                p.grad = torch.tensor(grads[3][k])
            opt.step()
        for p, q in zip(dst.param_groups[0]["params"], src.param_groups[0]["params"]):
            assert torch.equal(p, q)
            for key in src.state[q]:
                assert torch.equal(dst.state[p][key].cpu(), src.state[q][key].cpu()), key


@pytest.mark.parametrize("optim", ["RAdam", "AdaBound"])
def test_graph_step_body_equals_eager_step(optim):
    """The udaiic step as ``GraphStep`` (off a card its body runs eagerly)
    with the graph-built optimizer against the eager step with the plain
    one, 4 steps from the same weights and generator seed."""
    runs = {}
    for graph in (True, False):
        model, proj, opt, gen = _fresh(optim=optim, graph=graph)
        step = _step(model, proj, opt, gen, None, jit=graph)
        fn = graphs.GraphStep(step) if graph else step
        metrics = [fn(b) for b in _card_batches(4, seed=2)]
        state = optimizer_state_dict(opt)
        runs[graph] = (metrics, model.state_dict(), proj.state_dict(), state,
                       int(step.step_counter))
    (m_g, model_g, proj_g, st_g, n_g), (m_e, model_e, proj_e, st_e, n_e) = runs[True], runs[False]
    assert n_g == n_e == 4
    for a, b in zip(m_g, m_e):
        for key in b:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)
    for got, want in ((model_g, model_e), (proj_g, proj_e)):
        for name, value in want.items():
            torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)
    # the tensor lr holds the float's fp32 rounding, which the step multiplies in either way
    assert st_g["param_groups"][0]["lr"] == np.float32(st_e["param_groups"][0]["lr"])
    for idx, entry in st_e["state"].items():
        for key, value in entry.items():
            torch.testing.assert_close(st_g["state"][idx][key], value, rtol=0, atol=0,
                                       msg=f"{idx}/{key}")
