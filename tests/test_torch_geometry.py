"""The port's pose algebra (dpdist_tpu_torch/geometry) against dpdist_tpu's,
on the CPU in float32, on inputs seeded with numpy.

Tolerances: matrices, quaternions and points within 2e-6 (float32
rounding of a few products and sums in other orders); angles within 1e-4
rad; geodesic errors within 1e-3 degrees where the angle is away from 0
and 180, and within 0.05 degrees near them, where the arccos's slope is
unbounded: one float32 ulp of a cosine near 1 is ~0.02 degrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu import geometry as jg
from dpdist_tpu.geometry import se3 as jse3

from dpdist_tpu_torch import geometry as tg
from dpdist_tpu_torch.geometry import se3 as tse3

TOL = 2e-6
TOL_ANGLE = 1e-4
TOL_DEG, TOL_DEG_EDGE = 1e-3, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread: these eager ops are small, and on a CPU shared by
    the suite's parallel workers a thread pool's barriers wait on cores
    that other workers hold (with 8 threads, the registration CLI test's
    training took 186 s among 6 workers against 4.4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _angles(seed, n=64, lim=np.pi):
    return np.random.default_rng(seed).uniform(-lim, lim, (3, n)).astype(np.float32)


def _rotations(seed, n=64):
    rx, ry, rz = _angles(seed, n)
    return np.array(jg.euler_zyx_to_matrix(rx, ry, rz))


def test_euler_round_trip_and_gimbal_lock():
    rx, ry, rz = _angles(0, lim=np.pi / 2 * 0.999)
    _close(tg.euler_zyx_to_matrix(_t(rx), _t(ry), _t(rz)), jg.euler_zyx_to_matrix(rx, ry, rz))
    R = np.asarray(jg.euler_zyx_to_matrix(rx, ry, rz))
    for got, want in zip(tg.matrix_to_euler_zyx(_t(R)), jg.matrix_to_euler_zyx(R)):
        _close(got, want, TOL_ANGLE)
    # ry = +-90 degrees: |cos ry| < 1e-7, rz folds into rx; R[0, 2] past 1 is clipped.
    lock = np.array(jg.euler_zyx_to_matrix(np.float32([0.3, -0.7]),
                                             np.float32([np.pi / 2, -np.pi / 2]),
                                             np.float32([0.2, 0.4])))
    lock[:, 0, 0] = lock[:, 0, 1] = 0.0
    lock[0, 0, 2], lock[1, 0, 2] = 1.0 + 1e-6, -1.0 - 1e-6
    got, want = tg.matrix_to_euler_zyx(_t(lock)), jg.matrix_to_euler_zyx(lock)
    for g, w in zip(got, want):
        _close(g, w, TOL_ANGLE)
    assert float(got[2].abs().max()) == 0.0 and bool(torch.isfinite(got[1]).all())


def test_quaternions():
    r = np.random.default_rng(1)
    q = r.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0   # the eps keeps a zero quaternion finite
    _close(tg.normalize_quat(_t(q)), jg.normalize_quat(q))
    qn = np.asarray(jg.normalize_quat(q))
    _close(tg.quat_to_matrix(_t(qn)), jg.quat_to_matrix(qn))
    b = np.asarray(jg.normalize_quat(r.normal(size=(64, 4)).astype(np.float32)))
    _close(tg.quat_multiply(_t(qn), _t(b)), jg.quat_multiply(qn, b))
    six = r.normal(size=(64, 6)).astype(np.float32)
    _close(tg.rotation_6d_to_matrix(_t(six)), jg.rotation_6d_to_matrix(six), 1e-5)


def test_matrix_to_quat_takes_each_branch():
    """Shepperd's four cases: trace > 0 (small rotations), then m00, m11,
    m22 dominant (rotations near 180 degrees about x, y and z)."""
    small = np.asarray(jg.euler_zyx_to_matrix(*_angles(2, 16, lim=0.5)))
    flips = []
    for axis in range(3):
        ang = np.zeros((3, 8), np.float32)
        ang[axis] = np.pi - np.random.default_rng(axis).uniform(0, 0.3, 8)
        flips.append(np.asarray(jg.euler_zyx_to_matrix(*ang)))
    R = np.concatenate([small] + flips + [np.eye(3, dtype=np.float32)[None]])
    m = R[:, [0, 1, 2], [0, 1, 2]]
    branch = np.where(m.sum(1) > 0, 0, np.where((m[:, 0] >= m[:, 1]) & (m[:, 0] >= m[:, 2]), 1,
                                                 np.where(m[:, 1] >= m[:, 2], 2, 3)))
    assert set(branch) == {0, 1, 2, 3}
    got, want = tg.matrix_to_quat(_t(R)), np.asarray(jg.matrix_to_quat(R))
    _close(got, want, 1e-5)
    _close(tg.quat_to_matrix(got), R, 1e-5)


def test_geodesic_error_at_identity_generic_and_near_180():
    R = _rotations(3)
    rx, ry, rz = _angles(4, lim=0.2)
    d = np.asarray(jg.euler_zyx_to_matrix(rx, ry, rz))
    generic = np.asarray(jg.euler_zyx_to_matrix(*_angles(5, lim=1.0)))
    Rg = np.einsum("bij,bjk->bik", R, generic)
    want = np.asarray(jg.rotation_geodesic_error(R, Rg))
    assert want.min() > 1.0 and want.max() < 179.0
    _close(tg.rotation_geodesic_error(_t(R), _t(Rg)), want, TOL_DEG)
    # the identity: cos = 1 exactly (clip) and tiny rotations around it
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), R.shape)
    _close(tg.rotation_geodesic_error(_t(R), _t(R)), jg.rotation_geodesic_error(R, R),
           TOL_DEG_EDGE)
    assert float(tg.rotation_geodesic_error(_t(eye), _t(eye)).abs().max()) == 0.0
    tiny = np.asarray(jg.euler_zyx_to_matrix(*(_angles(6, lim=1e-3))))
    _close(tg.rotation_geodesic_error(_t(eye), _t(tiny)), jg.rotation_geodesic_error(eye, tiny),
           TOL_DEG_EDGE)
    # near 180 degrees: cos near -1, clipped below
    flip = np.einsum("bij,jk->bik", d, np.diag([1.0, -1.0, -1.0]).astype(np.float32))
    got = tg.rotation_geodesic_error(_t(eye), _t(flip))
    _close(got, jg.rotation_geodesic_error(eye, flip), TOL_DEG_EDGE)
    assert float(got.min()) > 150.0 and bool(torch.isfinite(got).all())


def test_se3():
    r = np.random.default_rng(7)
    pose6 = np.concatenate([r.uniform(-0.3, 0.3, (16, 3)), r.uniform(-np.pi, np.pi, (16, 3))],
                           1).astype(np.float32)
    pose7 = r.normal(size=(16, 7)).astype(np.float32)
    pts = r.uniform(-1, 1, (16, 32, 3)).astype(np.float32)
    T6, T7 = np.asarray(jg.pose6_to_matrix(pose6)), np.asarray(jg.pose7_to_matrix(pose7))
    _close(tg.pose6_to_matrix(_t(pose6)), T6)
    _close(tg.pose7_to_matrix(_t(pose7)), T7)
    _close(tg.apply_pose6(_t(pts), _t(pose6)), jg.apply_pose6(pts, pose6), 1e-5)
    q = np.asarray(jg.normalize_quat(pose7[:, 3:]))
    _close(tg.apply_quat(_t(pts), _t(q), _t(pose7[:, :3])), jg.apply_quat(pts, q, pose7[:, :3]),
           1e-5)
    _close(tg.apply_transform(_t(pts), _t(T6)), jg.apply_transform(pts, T6), 1e-5)
    _close(tg.compose_transforms(_t(T7), _t(T6)), jg.compose_transforms(T7, T6), 1e-5)
    _close(tg.invert_transform(_t(T6)), jg.invert_transform(T6), 1e-5)
    _close(tse3.matrix_to_pose6(_t(T6)), jse3.matrix_to_pose6(T6), TOL_ANGLE)
    te, re = tg.transform_errors(_t(T7), _t(T6))
    jte, jre = jg.transform_errors(T7, T6)
    _close(te, jte, 1e-5)
    _close(re, jre, TOL_DEG)
    _close(tse3.convergence_measure(_t(T7), _t(T6)), jse3.convergence_measure(T7, T6), 1e-4)
    _close(tse3.convergence_measure(_t(T6), _t(T6)), jse3.convergence_measure(T6, T6), 1e-5)


def test_pose_gradients_match_jax():
    """d/dpose7 of a scalar of the composed transform and of the geodesic
    error (the trainer and the evaluator differentiate through these)."""
    r = np.random.default_rng(8)
    pose7 = r.normal(size=(8, 7)).astype(np.float32)
    T0 = np.asarray(jg.pose6_to_matrix(r.uniform(-1, 1, (8, 6)).astype(np.float32)))
    w = r.normal(size=(8, 4, 4)).astype(np.float32)

    def jax_f(p):
        T = jse3.compose_transforms(jse3.pose7_to_matrix(p), T0)
        return jnp.sum(T * w) + jnp.sum(jg.rotation_geodesic_error(T[:, :3, :3], T0[:, :3, :3]))

    want = jax.grad(jax_f)(pose7)
    p = _t(pose7).requires_grad_(True)
    T = tse3.compose_transforms(tse3.pose7_to_matrix(p), _t(T0))
    f = torch.sum(T * _t(w)) + torch.sum(tg.rotation_geodesic_error(T[:, :3, :3],
                                                                    _t(T0)[:, :3, :3]))
    (got,) = torch.autograd.grad(f, p)
    _close(got, want, 1e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("family", ["chair", "cylinder", "torus", "capsule", "cone", "box",
                                    "sphere", None])
def test_symmetry_aware_errors_per_family(family):
    """The numpy copy gives the reference's numbers per family, including
    poses that land on a symmetry (a flip about x, a twist about z)."""
    from dpdist_tpu.geometry.symmetry import symmetry_aware_errors as jsym

    R_gt = _rotations(9, 32).astype(np.float64)
    twist = np.asarray(jg.euler_zyx_to_matrix(*np.float32([[0.0] * 32, [0.0] * 32,
                                                          np.linspace(-3, 3, 32)])))
    R_pred = np.einsum("bij,bjk->bik", R_gt, twist)
    R_pred[::4] = np.einsum("bij,jk->bik", R_gt[::4], np.diag([1.0, -1.0, -1.0]))
    R_pred[1::4] = _rotations(10, 8)
    fams = [family] * 32
    np.testing.assert_array_equal(tg.symmetry_aware_errors(R_pred, R_gt, fams),
                                  jsym(R_pred, R_gt, fams))
    assert tg.FAMILY_SYMMETRY == jg.FAMILY_SYMMETRY
