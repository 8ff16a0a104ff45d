"""The simulator the port's tests and smoke run use: duet_tpu's
framework-free diploid genome + long-read simulator, re-exported."""

from duet_tpu.sim import SimConfig, SimTruth, simulate_dataset

__all__ = ["SimConfig", "SimTruth", "simulate_dataset"]
