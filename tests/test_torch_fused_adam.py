"""The optimizer's two Adam paths (train/optim.py): the list path of
PyTorch ops on the CPU, the fused kernel (kernels/fused_adam.py,
csrc/fused_adam.cu) on CUDA.

On the CPU: what the kernel refuses, the list path on every layout and
dtype, the momentum optimizer outside the kernel, and the state a step
returns. On the card (marked gpu, skipped elsewhere): the kernel path
equal to the list path bit for bit on p, mu and nu after 3 steps, the
leaves it refuses, and the spent state (moments updated in place, version
counters bumped).
This file imports nothing of JAX; the tests against optax are in
test_torch_losses_optim.py.

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fused_adam.py
"""

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.configs import TrainConfig
from dpdist_tpu_torch.kernels import fused_adam as fa
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.train import optim
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
from dpdist_tpu_torch.train.optim import B1, B2, EPS, make_optimizer

# The production 3DmFV AUE's 24 leaves, its 402.7 M-weight decoder layer
# cut to 1/64 (393,216 -> 6,144 rows).
AUE_SHAPES = [(1024,), (1024,), (192,), (192,), (1024,), (6144, 1024), (192,), (1024, 192),
              (256,), (256,), (128,), (128,), (128,), (128,), (256,), (256,), (256,),
              (1, 1, 1, 20, 256), (128,), (3, 3, 3, 256, 128), (128,), (5, 5, 5, 256, 128),
              (256,), (1, 1, 1, 20, 256)]
# The DPDist train net's 8: the decoder 2,503-1,024-1,024-1,024-3.
DPDIST_SHAPES = [(2503, 1024), (1024,), (1024, 1024), (1024,), (1024, 1024), (1024,),
                 (1024, 3), (3,)]
# Lengths off the 16-byte vectors, one within a chunk of 4,096 and one past.
ODD_SHAPES = [(1,), (3,), (5,), (4 * 1000 + 3,), (4 * 5000 + 3,)]
SHAPES = AUE_SHAPES + DPDIST_SHAPES + ODD_SHAPES


def _params(shapes, device, seed=0, dtype=torch.float32):
    """{"l00": {"w" or "b": leaf}, ...}: "w" for a leaf of two or more axes,
    the leaves weight decay takes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {f"l{i:02d}": {"w" if len(s) > 1 else "b":
                          torch.randn(s, generator=gen, device=device).to(dtype)}
            for i, s in enumerate(shapes)}


def _grads(params, seed):
    leaves = [t for _, t in tree_flatten_with_paths(params)]
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    # Gradients over many orders of magnitude, so that the moments' sums
    # and the square root round at every scale.
    return [torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)
            * torch.exp(4 * torch.randn(t.shape, generator=gen, device=t.device)).to(t.dtype)
            for t in leaves]


def _steps(cfg, params, count=0, steps=3, seed=1):
    opt = make_optimizer(cfg)
    state = opt.init(params)
    state["count"] = count
    for k in range(steps):
        state = opt.step(params, _grads(params, seed + k), state)
    return state


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _launches():
    return fa.fused_adam.launches


def _list_path(ps, gs, ms, vs, lr, c1, c2, b1, b2, eps):
    """The list path under the kernel's contract: m and v written in place."""
    assert (b1, b2, eps) == (B1, B2, EPS)
    for p, g, m, v in zip(ps, gs, ms, vs):
        mu, nu = optim.adam_leaf_plain(p, g, m, v, lr, c1, c2)
        m.copy_(mu)
        v.copy_(nu)


def _refuse(*args):
    raise AssertionError("the fused Adam kernel was called")


# --- on the CPU --------------------------------------------------------------

def test_route_refuses_what_the_kernel_cannot_take():
    base = torch.zeros(4096)
    assert fa._dense(base)
    assert not fa._dense(base.to(torch.bfloat16))
    assert not fa._dense(base.to(torch.float16))
    assert not fa._dense(base.reshape(64, 64).t())            # not contiguous
    assert not fa._dense(base[1:])                            # a view at offset 1
    assert fa._dense(base[4:])                                # 16 bytes in: aligned
    # A CPU leaf never reaches the kernel: the wrapper raises before any build.
    launched = _launches()
    with pytest.raises(ValueError, match="CUDA float32"):
        fa.fused_adam([base], [base], [base], [base], 1e-3, 0.1, 0.001, B1, B2, EPS)
    assert _launches() == launched


def test_cpu_leaves_take_the_list_path(monkeypatch):
    """Every CPU leaf, whatever its layout or dtype, takes the list path and
    matches the optimizer's list code as it was before the kernel."""
    monkeypatch.setattr(optim, "fused_adam", _refuse)
    buf = torch.randn(1001, generator=torch.Generator().manual_seed(3))
    params = {"a": {"w": torch.randn(40, 30)},                       # plain float32
              "b": {"w": torch.randn(30, 40).t()},                   # not contiguous
              "c": {"b": buf[1:]},                                   # offset 1
              "d": {"b": torch.randn(77).to(torch.bfloat16)}}        # bf16
    want = {p: t.clone() for p, t in tree_flatten_with_paths(params)}
    cfg = TrainConfig(learning_rate=1e-3)
    state = _steps(cfg, params)
    # The list path as it was: new moments from PyTorch ops, then the update.
    mu = {p: torch.zeros_like(t) for p, t in want.items()}
    nu = {p: torch.zeros_like(t) for p, t in want.items()}
    lr = optim.staircase_lr(cfg.learning_rate, cfg.decay_step, cfg.decay_rate, cfg.lr_floor)
    for k in range(3):
        grads = _grads(params, 1 + k)
        c1, c2 = (float(np.float32(1) - np.power(np.float32(b), np.float32(k + 1),
                                                 dtype=np.float32)) for b in (B1, B2))
        for (p, t), g in zip(sorted(want.items()), grads):
            mu[p] = (1 - B1) * g + B1 * mu[p]
            nu[p] = (1 - B2) * g * g + B2 * nu[p]
            t.sub_(lr(k) * ((mu[p] / c1) / (torch.sqrt(nu[p] / c2) + EPS)))
    for i, (p, t) in enumerate(tree_flatten_with_paths(params)):
        assert _same(t, want[p]), p
        assert _same(state["mu"][i], mu[p]) and _same(state["nu"][i], nu[p]), p


def test_momentum_never_reaches_the_kernel(monkeypatch):
    monkeypatch.setattr(optim, "fused_adam", _refuse)
    launched = _launches()
    state = _steps(TrainConfig(optimizer="momentum", learning_rate=1e-2),
                   _params(ODD_SHAPES, "cpu"))
    assert set(state) == {"count", "trace"} and _launches() == launched


@pytest.mark.parametrize("change", [{}, {"weight_decay": 0.01, "grad_clip": 0.5}])
def test_state_after_a_step_holds_the_new_moments(change):
    """The drivers read mu right after step 0 (the first gradient times
    1 - b1); the state each step returns carries the moments the next step
    takes, in the order of the leaves."""
    cfg = TrainConfig(learning_rate=1e-3, **change)
    params = _params(AUE_SHAPES[:6] + ODD_SHAPES, "cpu")
    opt = make_optimizer(cfg)
    grads = _grads(params, 1)
    state = opt.step(params, grads, opt.init(params))
    assert state["count"] == 1
    assert [m.shape for m in state["mu"]] == [t.shape for _, t in tree_flatten_with_paths(params)]
    if not change:
        assert all(_same(m, (1 - B1) * g) for m, g in zip(state["mu"], grads))
        assert all(_same(v, (1 - B2) * g * g) for v, g in zip(state["nu"], grads))
    for k in (1, 2):
        state = opt.step(params, _grads(params, 1 + k), state)
    ref = _params(AUE_SHAPES[:6] + ODD_SHAPES, "cpu")
    want = _steps(cfg, ref)
    for key in ("mu", "nu"):
        assert all(_same(a, b) for a, b in zip(state[key], want[key]))
    for (_, a), (_, b) in zip(tree_flatten_with_paths(params), tree_flatten_with_paths(ref)):
        assert _same(a, b)


def test_params_to_device_makes_dense_leaves():
    """The trainers build and restore their leaves with params_to_device; a
    checkpoint may hold a leaf in Fortran order (the committed registration
    policy does), and the kernel takes only dense leaves, so every copy is
    contiguous, with the source's values, shape and dtype float32."""
    src = {"f": np.asfortranarray(np.arange(12, dtype=np.float64).reshape(3, 4)),
           "t": torch.arange(12.0).reshape(4, 3).t(),
           "s": np.float32(2.5)}
    out = params_to_device(src, "cpu", requires_grad=True)
    for k, t in out.items():
        assert t.is_contiguous() and t.dtype == torch.float32 and t.requires_grad, k
        assert torch.equal(t.detach(), torch.as_tensor(np.asarray(src[k]), dtype=torch.float32)), k
    assert out["s"].shape == () and out["f"].shape == (3, 4) and out["t"].shape == (3, 4)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _both_paths(monkeypatch, cfg, shapes, device, count=0, steps=3):
    """(params, state) after `steps` steps by the kernel path and by the list path."""
    fused = _params(shapes, device)
    launched = _launches()
    s_fused = _steps(cfg, fused, count, steps)
    got = _launches() - launched
    with monkeypatch.context() as m:
        m.setattr(optim, "fused_adam", _list_path)
        plain = _params(shapes, device)
        s_plain = _steps(cfg, plain, count, steps)
    return (fused, s_fused), (plain, s_plain), got


def _assert_bitwise(a, b):
    (pa, sa), (pb, sb) = a, b
    for (path, x), (_, y) in zip(tree_flatten_with_paths(pa), tree_flatten_with_paths(pb)):
        assert _same(x, y), f"p of {path}: {(x != y).sum().item()} elements differ"
    for key in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(sa[key], sb[key])):
            assert _same(x, y), f"{key}[{i}]: {(x != y).sum().item()} elements differ"


@pytest.mark.gpu
@pytest.mark.parametrize("count,change", [
    (0, {}), (1, {}), (10_000, {}),
    (10_000, {"decay_step": 100, "decay_rate": 0.5}),        # lr at the staircase floor
    (0, {"weight_decay": 0.01}), (1, {"grad_clip": 0.5}),
    (10_000, {"weight_decay": 0.01, "grad_clip": 0.5}),
])
def test_kernel_equals_the_list_path_bit_for_bit(cuda, monkeypatch, count, change):
    cfg = TrainConfig(learning_rate=1e-3, **change)
    if "decay_step" in change:
        assert optim.staircase_lr(cfg.learning_rate, cfg.decay_step, cfg.decay_rate,
                                  cfg.lr_floor)(count) == pytest.approx(cfg.lr_floor)
    fused, plain, launches = _both_paths(monkeypatch, cfg, SHAPES, cuda, count)
    assert launches == 3
    _assert_bitwise(fused, plain)


@pytest.mark.gpu
def test_kernel_splits_a_long_table_into_launches(cuda, monkeypatch):
    shapes = [(4 * i + 1,) for i in range(70)] + [(9000,)] * 60
    fused, plain, launches = _both_paths(
        monkeypatch, TrainConfig(learning_rate=1e-3), shapes, cuda, steps=1)
    assert launches == -(-130 // fa._max_leaves())
    _assert_bitwise(fused, plain)


@pytest.mark.gpu
def test_kernel_copies_strided_gradients(cuda, monkeypatch):
    """A conv weight's gradient as autograd hands it back (a permuted view)
    and gradients as views into one flat buffer at odd offsets (data
    parallelism's all-reduce) are copied; their leaves still take the
    kernel, bit for bit the list path."""
    shapes = [(300, 200), (5, 5, 5, 8, 16), (777,), (3,)]

    def run(params):
        opt = make_optimizer(TrainConfig(learning_rate=1e-3))
        state = opt.init(params)
        for k in range(3):
            grads = _grads(params, 10 + k)
            grads[1] = grads[1].permute(4, 3, 0, 1, 2).contiguous().permute(2, 3, 4, 1, 0)
            flat = torch.cat([torch.zeros(1, device=cuda), grads[2].flatten(), grads[3]])
            grads[2], grads[3] = flat[1:778], flat[778:]
            assert not grads[1].is_contiguous() and grads[2].data_ptr() % 16
            state = opt.step(params, grads, state)
        return state

    fused = _params(shapes, cuda)
    launched = _launches()
    s_fused = run(fused)
    assert _launches() - launched == 3
    with monkeypatch.context() as m:
        m.setattr(optim, "fused_adam", _list_path)
        plain = _params(shapes, cuda)
        s_plain = run(plain)
    _assert_bitwise((fused, s_fused), (plain, s_plain))


@pytest.mark.gpu
@pytest.mark.parametrize("leaf", ["bf16", "transposed", "offset 1"])
def test_kernel_refuses_a_leaf_it_cannot_take(cuda, leaf):
    """On the card every Adam leaf goes to the kernel: one it cannot take
    raises before any launch, and nothing is updated."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    odd = {"bf16": lambda: torch.randn(777, generator=gen, device=cuda).to(torch.bfloat16),
           "transposed": lambda: torch.randn(200, 300, generator=gen, device=cuda).t(),
           "offset 1": lambda: torch.randn(4097, generator=gen, device=cuda)[1:]}[leaf]()
    params = {"a": {"w": torch.randn(300, 200, generator=gen, device=cuda)}, "b": {"w": odd}}
    before = [t.clone() for _, t in tree_flatten_with_paths(params)]
    opt = make_optimizer(TrainConfig(learning_rate=1e-3))
    state = opt.init(params)
    launched = _launches()
    with pytest.raises(ValueError, match="CUDA float32"):
        opt.step(params, [torch.ones_like(t) for t in before], state)
    assert _launches() == launched
    assert all(_same(a, b) for (_, a), b in zip(tree_flatten_with_paths(params), before))


@pytest.mark.gpu
def test_kernel_path_spends_the_old_state(cuda):
    """The old state's moments are the returned ones, updated in place; the
    kernel bumps the version counters of p, mu and nu as p.sub_ did, so a
    graph that saved p before the step refuses to run backward after it."""
    params = _params(DPDIST_SHAPES[-2:], cuda)
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_paths(params)]
    opt = make_optimizer(TrainConfig(learning_rate=1e-3))
    old = opt.init(params)
    moments = [*old["mu"], *old["nu"]]
    versions = [t._version for t in leaves + moments]
    saved = sum((t * t).sum() for t in leaves)
    grads = _grads(params, 1)
    new = opt.step(params, grads, old)
    assert all(a is b for a, b in zip([*new["mu"], *new["nu"]], moments))
    assert all(_same(m, (1 - B1) * g) for m, g in zip(old["mu"], grads))
    assert all(t._version > v for t, v in zip(leaves + moments, versions))
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        saved.backward()


@pytest.mark.gpu
def test_kernel_on_the_full_decoder_leaf(cuda, monkeypatch):
    """The AUE's 402,653,184-weight leaf, 2 steps."""
    fused, plain, launches = _both_paths(
        monkeypatch, TrainConfig(learning_rate=1e-3), [(393216, 1024)], cuda, steps=2)
    assert launches == 2
    _assert_bitwise(fused, plain)
