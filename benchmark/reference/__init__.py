"""The plain reference that judges the port's plans.

Plain PyTorch in float64, written from the published formulas of GPMP2
(the constant-velocity GP prior and interpolation, the DH arm, SE(2), the
hinge obstacle cost on a signed distance field). It imports nothing of
gpmp2_tpu_torch and takes nothing the port made: the occupancy grid,
the robot tables, the setting and the endpoints are the benchmark's
inputs, and the port's outputs are read only to be judged.
"""
