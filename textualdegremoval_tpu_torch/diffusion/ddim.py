"""DDIM scheduler and the classifier-free-guidance sampler.

Counterpart of textualdegremoval_tpu/diffusion/ddim.py: diffusers
DDIMScheduler as the reference uses it (scaled-linear betas 0.00085 to
0.012 taken in float64 and cast to float32, 1000 training steps,
steps_offset 1, eta 0) and its 100-step CFG loop, the cond/uncond pair as
one batch-2N UNet call per step.  The JAX sampler is one `lax.scan`; here
it is a Python loop over the timesteps.

Type promotion: in JAX, `alphas_cumprod[t]` is a non-weak float32 0-d
array, so every scheduler product with a bf16 model output is float32; in
torch a 0-d float32 tensor times a bf16 tensor stays bf16.  So the
scheduler casts its operands to float32 explicitly, and the latents stay
float32 between steps.  The guided sum `out_u + scale * (out_c - out_u)`
stays in the UNet's dtype in both frameworks (a Python float is weak in
JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"  # or "v_prediction"
    steps_offset: int = 1

    @property
    def alphas_cumprod(self) -> np.ndarray:
        betas = np.linspace(
            self.beta_start ** 0.5, self.beta_end ** 0.5,
            self.num_train_timesteps, dtype=np.float64) ** 2
        return np.cumprod(1.0 - betas).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
        return (ts + self.steps_offset).astype(np.int32)

    def _acp_at(self, t, ndim: int, device) -> torch.Tensor:
        """alphas_cumprod[t] as float32, broadcast over ndim dimensions."""
        acp = torch.from_numpy(self.alphas_cumprod).to(device)[
            torch.as_tensor(t, device=device).long()]
        return acp.reshape(acp.shape + (1,) * (ndim - acp.ndim))

    def add_noise(self, x0, noise, t):
        acp = self._acp_at(t, x0.ndim, x0.device)
        return torch.sqrt(acp) * x0.float() + torch.sqrt(1.0 - acp) \
            * noise.float()

    def velocity(self, x0, noise, t):
        """v-prediction target: sqrt(acp) eps - sqrt(1 - acp) x0."""
        acp = self._acp_at(t, x0.ndim, x0.device)
        return torch.sqrt(acp) * noise.float() - torch.sqrt(1.0 - acp) \
            * x0.float()

    def step(self, model_out, t: int, t_prev: int, sample):
        """Deterministic DDIM step (eta 0), in float32."""
        dev = sample.device
        acp = self.alphas_cumprod
        a_t = torch.tensor(acp[t], dtype=torch.float32, device=dev)
        a_prev = torch.tensor(acp[t_prev] if t_prev >= 0 else 1.0,
                              dtype=torch.float32, device=dev)
        m, s = model_out.float(), sample.float()
        if self.prediction_type == "epsilon":
            x0 = (s - torch.sqrt(1 - a_t) * m) / torch.sqrt(a_t)
            eps = m
        else:  # v_prediction
            x0 = torch.sqrt(a_t) * s - torch.sqrt(1 - a_t) * m
            eps = torch.sqrt(a_t) * m + torch.sqrt(1 - a_t) * s
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


def cfg_sample(eps_fn: Callable, scheduler: DDIMScheduler,
               latents: torch.Tensor, cond_context: torch.Tensor,
               uncond_context: torch.Tensor, num_inference_steps: int = 100,
               guidance_scale: float = 5.0) -> torch.Tensor:
    """DDIM CFG sampling loop.

    eps_fn: (latents_2b, t_2b, context_2b) -> model outputs; the caller
      binds the UNet (and use_global_kv) into it.
    latents: (B, h, w, 4) initial noise; cond_context / uncond_context:
      (B, S, D) text states.  Returns the final latents (B, h, w, 4),
      float32."""
    ts = scheduler.timesteps(num_inference_steps)
    ratio = scheduler.num_train_timesteps // num_inference_steps
    context = torch.cat([uncond_context, cond_context], dim=0)
    lat = latents.float()
    for t in ts.tolist():
        b = lat.shape[0]
        tt = torch.full((2 * b,), t, dtype=torch.int32, device=lat.device)
        out = eps_fn(torch.cat([lat, lat], dim=0), tt, context)
        out_u, out_c = out.chunk(2, dim=0)
        guided = out_u + guidance_scale * (out_c - out_u)
        lat = scheduler.step(guided, t, t - ratio, lat)
    return lat
