"""Port's arm FK + sphere Jacobians (plain twin of kernel K2) vs the JAX package.

JAX references: the plain-array twin `_fk_spheres_jnp` and
`sphere_centers_and_jac` in float64, and the Pallas kernel in interpret
mode in float32 (its frame scratch is float32, fk_arm.py:179, so a float64
comparison with it would be meaningless). The kernel itself runs only on
a card in test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry import so3
from gpmp2_tpu.geometry.se3 import Pose3 as JPose3
from gpmp2_tpu.kinematics.fk import ArmFK as JArmFK
from gpmp2_tpu.kinematics.robot import make_robot_model as j_make_robot_model
from gpmp2_tpu.kinematics.robot import sphere_centers_and_jac as j_centers_and_jac
from gpmp2_tpu.ops.fk_arm import (_fk_spheres_jnp, _structure_arrays,
                                  arm_fk_spheres_pallas)
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu_torch.kinematics.robot import sphere_centers_and_jac
from gpmp2_tpu_torch.ops.fk_arm import (arm_fk_spheres_batched,
                                        fk_spheres_torch,
                                        structure_arrays)
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.utils.convert import robot_model_from_numpy


def _port_robot(jmodel, dtype):
    fk = jmodel.fk
    return robot_model_from_numpy(
        *(np.asarray(x) for x in (fk.a, fk.alpha, fk.d, fk.theta_bias,
                                  fk.base_rot, fk.base_trans,
                                  jmodel.sphere_link_ids, jmodel.sphere_radii,
                                  jmodel.sphere_centers)),
        dtype=dtype, device="cpu")


def _three_link(dtype):
    base = JPose3(so3.rotx(jnp.asarray(0.3, dtype)) @ so3.rotz(jnp.asarray(-0.5, dtype)),
                  jnp.asarray([0.2, -0.1, 0.4], dtype))
    fk = JArmFK.create(a=[0.4, 0.3, 0.2], alpha=[np.pi / 2, -np.pi / 2, 0.0],
                       d=[0.1, 0.0, 0.05], theta_bias=[0.1, -0.2, 0.3],
                       base_pose=base, dtype=dtype)
    return j_make_robot_model(
        fk, [(0, 0.05, (0.0, 0.0, 0.1)), (1, 0.05, (-0.1, 0.05, 0.0)),
             (2, 0.04, (0.0, 0.1, -0.05)), (2, 0.04, (0.05, 0.0, 0.0))],
        dtype=dtype)


def _wam_four_spheres(dtype):
    """WAMArm's DH chain with 4 of its 16 spheres (links 0, 3, 5, 6): the
    XLA compile of the interpret-mode kernel grows steeply with the
    unrolled sphere count (measured on a CPU: ~20 s at 4 spheres, ~2 min
    at 6, ~3 min at 16). The full table is held against the JAX package's
    float64 paths below."""
    wam = j_generate_arm("WAMArm", dtype=dtype)
    keep = [0, 6, 9, 15]
    return j_make_robot_model(
        wam.fk, [(int(wam.sphere_link_ids[i]), float(wam.sphere_radii[i]),
                  tuple(float(v) for v in wam.sphere_centers[i])) for i in keep],
        dtype=dtype)


# name: (JAX model factory, joint range of the random configurations)
ROBOTS = {
    "wam": (lambda dtype: j_generate_arm("WAMArm", dtype=dtype), 2.0),
    "wam_four_spheres": (_wam_four_spheres, 2.0),
    "three_link_base": (_three_link, 3.0),
}


def _configs(name, N, dtype):
    rng = np.random.default_rng(len(name) + N)
    d = 3 if name.startswith("three") else 7
    return rng.uniform(-ROBOTS[name][1], ROBOTS[name][1], (N, d)).astype(dtype)


@pytest.mark.parametrize("name", ["wam", "three_link_base"])
def test_plain_matches_jax_f64(name):
    jmodel = ROBOTS[name][0](jnp.float64)
    q = _configs(name, 300, np.float64)
    # jitted: the JAX package's eager dispatch takes several times its compile
    c_j, J_j = jax.jit(_fk_spheres_jnp)(*_structure_arrays(jmodel.fk, jmodel, jnp.float64),
                                        jnp.asarray(q))
    c_a, J_a = jax.jit(jax.vmap(lambda qq: j_centers_and_jac(jmodel, qq)))(jnp.asarray(q))

    model = _port_robot(jmodel, torch.float64)
    c, J = fk_spheres_torch(*structure_arrays(model, torch.float64, "cpu"),
                            torch.from_numpy(q))
    c_r, J_r = sphere_centers_and_jac(model, torch.from_numpy(q))
    for mine in ((c, J), (c_r, J_r)):
        for ref in ((c_j, J_j), (c_a, J_a)):
            np.testing.assert_allclose(mine[0].numpy(), np.asarray(ref[0]), atol=1e-12)
            np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]), atol=1e-12)


@pytest.mark.parametrize("name", ["wam_four_spheres", "three_link_base"])
def test_plain_matches_pallas_interpret_f32(name):
    jmodel = ROBOTS[name][0](jnp.float32)
    q = _configs(name, 300, np.float32)
    d, S = q.shape[1], jmodel.num_spheres
    c_k, J_k = arm_fk_spheres_pallas(
        *_structure_arrays(jmodel.fk, jmodel, jnp.float32), jnp.asarray(q),
        d=d, S=S, interpret=True)
    model = _port_robot(jmodel, torch.float32)
    c, J = fk_spheres_torch(*structure_arrays(model, torch.float32, "cpu"),
                            torch.from_numpy(q))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_k), atol=2e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_k), atol=2e-5)


@pytest.mark.parametrize("bad_id", [-1, 3, 16])
def test_robot_from_numpy_rejects_bad_link_id(bad_id):
    """The FK kernel indexes its frames by link id unchecked, so an id
    outside [0, n_links) must be refused where the table enters."""
    fk = _three_link(jnp.float64).fk
    with pytest.raises(ValueError, match="link ids"):
        robot_model_from_numpy(
            *(np.asarray(x) for x in (fk.a, fk.alpha, fk.d, fk.theta_bias,
                                      fk.base_rot, fk.base_trans)),
            np.array([0, bad_id]), np.array([0.05, 0.05]), np.zeros((2, 3)),
            dtype=torch.float64, device="cpu")


def test_batched_entry_keeps_leading_dims():
    model = generate_arm("WAMArm", dtype=torch.float64, device="cpu")
    qs = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (4, 5, 7)))
    c, J = arm_fk_spheres_batched(model, qs)
    c_r, J_r = sphere_centers_and_jac(model, qs)
    assert c.shape == (4, 5, 16, 3) and J.shape == (4, 5, 16, 3, 7)
    np.testing.assert_allclose(c.numpy(), c_r.numpy(), atol=1e-12)
    np.testing.assert_allclose(J.numpy(), J_r.numpy(), atol=1e-12)

