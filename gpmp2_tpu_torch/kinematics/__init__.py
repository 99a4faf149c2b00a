"""Robot kinematics (port of gpmp2_tpu/kinematics)."""

from .factors import (goal_factor_error, hinge_limit_cost, joint_limit_error,
                      velocity_limit_error, workspace_orientation_error, workspace_pose_error,
                      workspace_position_error)
from .fk import (ArmFK, PointRobotFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK, Pose2MobileBaseFK,
                 Pose2MobileVetLin2ArmsFK, Pose2MobileVetLinArmFK, dof_of, link_poses,
                 num_links_of, state_space_of)
from .robot import RobotModel, make_robot_model, sphere_centers_and_jac, sphere_centers_world

__all__ = ["ArmFK", "PointRobotFK", "Pose2MobileBaseFK", "Pose2MobileArmFK",
           "Pose2Mobile2ArmsFK", "Pose2MobileVetLinArmFK", "Pose2MobileVetLin2ArmsFK",
           "dof_of", "link_poses", "num_links_of", "state_space_of", "RobotModel",
           "make_robot_model", "sphere_centers_and_jac", "sphere_centers_world",
           "hinge_limit_cost", "joint_limit_error", "velocity_limit_error",
           "goal_factor_error", "workspace_position_error", "workspace_orientation_error",
           "workspace_pose_error"]
