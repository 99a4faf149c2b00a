"""The SE(2) base through gpmp2_tpu_torch.kinematics.robot.make_robot_model."""


def build(robot, dtype, device):
    from gpmp2_tpu_torch.kinematics.fk import Pose2MobileBaseFK
    from gpmp2_tpu_torch.kinematics.robot import make_robot_model

    spheres = [(int(r[0]), float(r[4]), (float(r[1]), float(r[2]), float(r[3])))
               for r in robot["spheres"]]
    return make_robot_model(Pose2MobileBaseFK(), spheres, dtype=dtype, device=device)
