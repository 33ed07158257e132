"""Device-side (JAX/Pallas) compute ops: the cuVSLAM/ASIC replacement.

Everything here is jit-friendly: fixed shapes, masked variable-size results,
no data-dependent Python control flow. These ops implement on the
accelerator what the reference delegates to CUDA (cuVSLAM) and the OAK camera ASIC (StereoDepth)
— see reference launch/thor_visual_slam.launch.py and
thor_slam/camera/drivers/luxonis.py:513-536.
"""
