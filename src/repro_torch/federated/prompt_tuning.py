"""FedPrompt-style baseline: federated soft-prompt tuning (Zhao et al. 2023;
port of ``repro.federated.prompt_tuning``).

Instead of LoRA, each client trains a soft prompt (n_prompt, d_model)
prepended to the input embeddings (the decoder forward's ``prefix_embeds``,
dense, moe or vlm: there the soft prompt takes the patch embeddings' place);
the server FedAvgs the prompt, weighted by the clients' sample counts. Far
fewer parameters than LoRA (the paper's Table 13 comm numbers) but lower
accuracy (Table 1).

The JAX runner draws its base params and prompt from ``jax.random``, which
torch cannot replay: the constructor takes them as numpy arrays
(``init_params``, ``init_prompt``) and otherwise draws both from
``torch.Generator``s seeded from ``seed``. The LoRA stays all zeros (the
base model alone), as in the JAX package. Cohorts come from
``np.random.default_rng(seed)`` in the reference's order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.config import FibecFedConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.fibecfed import resolve_device, to_device
from repro_torch.data.pipeline import gather_batch, make_batches
from repro_torch.lora import zeros_like_lora
from repro_torch.models.model_api import ModelFns
from repro_torch.models.transformer import torch_dtype
from repro_torch.train.losses import label_token_loss


class FedPrompt:
    def __init__(
        self,
        model: ModelFns,
        fl: FibecFedConfig,
        client_data: Sequence[Dict[str, np.ndarray]],
        *,
        n_prompt: int = 16,
        seed: int = 0,
        device=None,
        init_params: Any = None,
        init_prompt: Any = None,
    ):
        """``device``: where the model and prompt live (``None``: the CUDA
        device, an error without one). ``init_params`` / ``init_prompt``:
        numpy arrays to start from (the JAX runner's ``params`` and
        ``prompt``)."""
        if model.cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError("prompt tuning needs a decoder")
        self.model = model
        self.fl = fl
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)

        def generator(stream: int) -> torch.Generator:
            return torch.Generator(device=self.device).manual_seed(seed * 1_000_003 + stream)

        if init_params is not None:
            self.params = params_from_numpy(init_params, model.cfg, self.device)
        else:
            self.params = model.init_params(generator(0), self.device)
        self.lora = zeros_like_lora(model.init_lora(generator(1), self.device))  # the base model only
        if init_prompt is not None:
            self.prompt = torch.tensor(np.asarray(init_prompt, np.float32), device=self.device)
        else:
            self.prompt = torch.randn((n_prompt, model.cfg.d_model), generator=generator(2),
                                      device=self.device) * 0.02
        self.clients = [
            {"data": cd, "n": len(next(iter(cd.values()))),
             "batches": make_batches(len(next(iter(cd.values()))), fl.batch_size)}
            for cd in client_data
        ]
        self.comm_bytes_per_round: List[int] = []
        self._dtype = torch_dtype(model.cfg.dtype)

    def _logits(self, prompt: torch.Tensor, batch: Dict[str, torch.Tensor]) -> tuple:
        B = batch["tokens"].shape[0]
        prefix = prompt[None].expand(B, *prompt.shape).to(self._dtype)
        return self.model.forward(self.params, self.lora, {**batch, "prefix_embeds": prefix})

    def _loss(self, prompt: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, aux = self._logits(prompt, batch)
        return label_token_loss(logits, batch["label_token"]) + aux

    def run_round(self, t: int) -> Dict[str, float]:
        """One round: each cohort client runs plain SGD on its own copy of the
        prompt over all its batches; the server averages the copies."""
        fl = self.fl
        k = min(fl.devices_per_round, len(self.clients))
        chosen = self.rng.choice(len(self.clients), k, replace=False)
        new_prompts, weights, losses = [], [], []
        for ci in chosen:
            c = self.clients[ci]
            prompt = self.prompt
            for ids in c["batches"]:
                batch = to_device(gather_batch(c["data"], ids), self.device)
                g, loss = grad_and_value(lambda p: self._loss(p, batch))(prompt)
                prompt = prompt - fl.learning_rate * g
                losses.append(float(loss))
            new_prompts.append(prompt)
            weights.append(c["n"])
        w = np.asarray(weights, np.float64)
        w /= w.sum()
        self.prompt = sum(float(wi) * p for wi, p in zip(w, new_prompts))
        self.comm_bytes_per_round.append(2 * k * int(self.prompt.numel()) * 4)
        return {"loss": float(np.mean(losses))}

    @torch.no_grad()
    def evaluate(self, data: Dict[str, np.ndarray], batch_size: int = 32) -> float:
        """Accuracy of the next token after the prompted sequence against
        ``label_token``."""
        n = len(next(iter(data.values())))
        correct = 0
        for i in range(0, n, batch_size):
            batch = {kk: v[i : i + batch_size] for kk, v in data.items()}
            logits, _ = self._logits(self.prompt, to_device(batch, self.device))
            pred = torch.argmax(logits[:, -1], -1).cpu().numpy()
            correct += int((pred == batch["label_token"]).sum())
        return correct / n
