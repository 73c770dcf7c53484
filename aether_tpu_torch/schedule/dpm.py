"""CogVideoX noise schedule + SDE-DPM-Solver++(2M) sampler.

Port of ``aether_tpu/schedule/dpm.py``. :func:`make_sampling_plan` is the same
host-side float64 numpy precomputation of every per-step coefficient, cast to
float32 tensors at the end; :func:`dpm_step` is the same pure update on
tensors. The IEEE-inf arithmetic at the two degenerate ends (first step with
zero SNR, terminal step with alpha_prev = 1) is kept as it is, so the plan
arrays equal the JAX plan's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.config import SchedulerConfig


def compute_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """Training-time cumulative alpha schedule (float64, length num_train_timesteps)."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    else:
        raise ValueError(f"Unsupported beta schedule: {cfg.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)

    # SD3-style SNR shift.
    s = cfg.snr_shift_scale
    alphas_cumprod = alphas_cumprod / (s + (1.0 - s) * alphas_cumprod)

    if cfg.rescale_betas_zero_snr:
        sqrt_ac = np.sqrt(alphas_cumprod)
        sqrt_0, sqrt_t = sqrt_ac[0], sqrt_ac[-1]
        sqrt_ac = (sqrt_ac - sqrt_t) * (sqrt_0 / (sqrt_0 - sqrt_t))
        alphas_cumprod = sqrt_ac**2
    return alphas_cumprod


def set_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps (int64) for the given spacing policy."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        timesteps = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    elif cfg.timestep_spacing == "linspace":
        timesteps = (
            np.linspace(0, n - 1, num_inference_steps).round()[::-1].astype(np.int64)
        )
    elif cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        timesteps = (
            (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        )
        timesteps = timesteps + cfg.steps_offset
    else:
        raise ValueError(f"Unsupported timestep spacing: {cfg.timestep_spacing}")
    return timesteps


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """Per-step sampler coefficients; every tensor has leading dim num_steps."""

    timesteps: torch.Tensor  # int32, the t fed to the DiT
    sqrt_alpha: torch.Tensor  # sqrt(alpha_prod_t)
    sqrt_one_minus_alpha: torch.Tensor  # sqrt(1 - alpha_prod_t)
    mult1: torch.Tensor  # x coefficient
    mult2: torch.Tensor  # denoised coefficient (subtracted)
    mult3: torch.Tensor  # second-order x0 coefficient (1 + 1/2r)
    mult4: torch.Tensor  # second-order old_x0 coefficient (1/2r)
    mult_noise: torch.Tensor  # fresh-noise scale (SDE term)
    second_order: torch.Tensor  # bool: use the 2M update at this step
    init_noise_sigma: float = 1.0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_sampling_plan(
    cfg: SchedulerConfig,
    num_inference_steps: int,
    timesteps: Optional[np.ndarray] = None,
    device: torch.device | str = "cpu",
) -> SamplingPlan:
    """Precompute all DPM-Solver++(2M) step coefficients on host in float64."""
    alphas_cumprod = compute_alphas_cumprod(cfg)
    if timesteps is None:
        timesteps = set_timesteps(cfg, num_inference_steps)
    else:
        timesteps = np.asarray(timesteps, dtype=np.int64)
        num_inference_steps = len(timesteps)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(alphas_cumprod[0])

    n_steps = len(timesteps)
    step_gap = cfg.num_train_timesteps // num_inference_steps

    sqrt_a = np.zeros(n_steps)
    sqrt_1ma = np.zeros(n_steps)
    m1 = np.zeros(n_steps)
    m2 = np.zeros(n_steps)
    m3 = np.zeros(n_steps)
    m4 = np.zeros(n_steps)
    m_noise = np.zeros(n_steps)
    second = np.zeros(n_steps, dtype=bool)

    def lamb_of(alpha: float) -> float:
        with np.errstate(divide="ignore"):
            return float(np.log(np.sqrt(alpha / max(1.0 - alpha, 0.0)))) if alpha < 1.0 else np.inf

    for i, t in enumerate(timesteps):
        prev_t = int(t) - step_gap
        alpha_t = float(alphas_cumprod[t])
        alpha_prev = float(alphas_cumprod[prev_t]) if prev_t >= 0 else final_alpha

        sqrt_a[i] = np.sqrt(alpha_t)
        sqrt_1ma[i] = np.sqrt(1.0 - alpha_t)

        lamb = lamb_of(alpha_t)
        lamb_next = lamb_of(alpha_prev)
        h = lamb_next - lamb
        # IEEE inf arithmetic reproduces the reference's torch behavior at the two
        # degenerate ends: first step (alpha_t = 0, h = +inf -> pure re-noising of
        # x0) and terminal step (alpha_prev = 1, h = +inf, mult1 = mult_noise = 0,
        # mult2 = -1 -> x_prev = x0 exactly).
        with np.errstate(over="ignore"):
            m1[i] = np.sqrt((1.0 - alpha_prev) / (1.0 - alpha_t)) * np.exp(-h)
            m2[i] = np.expm1(-2.0 * h) * np.sqrt(alpha_prev)
            m_noise[i] = np.sqrt(1.0 - alpha_prev) * np.sqrt(1.0 - np.exp(-2.0 * h))

        if i > 0 and prev_t >= 0:
            t_back = int(timesteps[i - 1])
            alpha_back = float(alphas_cumprod[t_back])
            lamb_prev = lamb_of(alpha_back)
            h_last = lamb - lamb_prev
            r = h_last / h  # r = inf at i=1 when t_back is the zero-SNR terminal
            m3[i] = 1.0 + 1.0 / (2.0 * r)
            m4[i] = 1.0 / (2.0 * r)
            second[i] = True

    device = torch.device(device)

    def put(a):
        # a card gets the tables through pinned memory and an asynchronous
        # copy, which does not wait for the work queued before it
        t = torch.from_numpy(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def f32(a):
        return put(a.astype(np.float32))

    return SamplingPlan(
        timesteps=put(timesteps.astype(np.int32)),
        sqrt_alpha=f32(sqrt_a),
        sqrt_one_minus_alpha=f32(sqrt_1ma),
        mult1=f32(m1),
        mult2=f32(m2),
        mult3=f32(m3),
        mult4=f32(m4),
        mult_noise=f32(m_noise),
        second_order=put(second),
        init_noise_sigma=cfg.init_noise_sigma,
    )


def predicted_x0(
    plan: SamplingPlan, i: int, sample: torch.Tensor, model_output: torch.Tensor,
    prediction_type: str = "v_prediction",
) -> torch.Tensor:
    """x0 estimate from the model output at step i."""
    if prediction_type == "v_prediction":
        return plan.sqrt_alpha[i] * sample - plan.sqrt_one_minus_alpha[i] * model_output
    if prediction_type == "epsilon":
        return (sample - plan.sqrt_one_minus_alpha[i] * model_output) / plan.sqrt_alpha[i]
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"Unsupported prediction type: {prediction_type}")


def dpm_step(
    plan: SamplingPlan,
    i: int,
    sample: torch.Tensor,
    model_output: torch.Tensor,
    old_x0: torch.Tensor,
    noise: torch.Tensor,
    prediction_type: str = "v_prediction",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SDE-DPM-Solver++(2M) update. Returns (x_{t_prev}, x0_pred).

    ``old_x0`` is the previous step's x0 prediction (zeros at i=0 — it is gated off
    by ``second_order[0] = False``). ``noise`` is a standard normal draw shaped like
    ``sample``; the terminal step has mult_noise = 0 so it is ignored there.
    Indexing the plan with a Python ``i`` keeps every coefficient on the device,
    so a step never waits for the host.
    """
    x0 = predicted_x0(plan, i, sample, model_output, prediction_type)
    x0_f32 = x0.float()
    d_second = plan.mult3[i] * x0_f32 - plan.mult4[i] * old_x0.float()
    denoised = torch.where(plan.second_order[i], d_second, x0_f32)
    prev = (
        plan.mult1[i] * sample.float()
        - plan.mult2[i] * denoised
        + plan.mult_noise[i] * noise.float()
    )
    return prev.to(sample.dtype), x0_f32
