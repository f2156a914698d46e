"""Perception for the 4D path: optical flow (only the exact synthetic
provider so far)."""
