from repro_torch.federated.baselines import BASELINES, make_runner, run_experiment
