from duet_tpu_torch.sim.simulate import SimConfig, SimTruth, simulate_dataset
