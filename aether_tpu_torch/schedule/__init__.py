from aether_tpu_torch.schedule.dpm import SamplingPlan, dpm_step, make_sampling_plan  # noqa: F401
