"""Artifacts: the Gaussian map as PLY, and checkpoints of the SLAM state."""
