"""A DH arm through gpmp2_tpu_torch.utils.convert.robot_model_from_numpy."""

import numpy as np


def build(robot, dtype, device):
    from gpmp2_tpu_torch.utils.convert import robot_model_from_numpy

    t = np.asarray(robot["spheres"], np.float64)
    return robot_model_from_numpy(robot["a"], robot["alpha"], robot["d"], robot["theta_bias"],
                                  robot["base_rot"], robot["base_trans"],
                                  t[:, 0].astype(np.int64), t[:, 4], t[:, 1:4],
                                  dtype=dtype, device=device)
