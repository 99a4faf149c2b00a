from .fk import (ArmFK, PointRobotFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK, Pose2MobileBaseFK,
                 Pose2MobileVetLin2ArmsFK, Pose2MobileVetLinArmFK, dof_of, link_poses,
                 num_links_of, state_space_of)
from .robot import RobotModel, make_robot_model, sphere_centers_and_jac, sphere_centers_world

__all__ = ["ArmFK", "PointRobotFK", "Pose2MobileBaseFK", "Pose2MobileArmFK",
           "Pose2Mobile2ArmsFK", "Pose2MobileVetLinArmFK", "Pose2MobileVetLin2ArmsFK",
           "dof_of", "link_poses", "num_links_of", "state_space_of", "RobotModel",
           "make_robot_model", "sphere_centers_and_jac", "sphere_centers_world"]
