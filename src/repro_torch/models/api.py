"""Model registry: one API over the model families the port serves.

`Model` exposes init / specs / loss / forward / prefill / decode /
init_cache; the server and the tests talk only to it. The port serves
the dense ``lm`` family, Mamba-2 and Griffin; an enc-dec config raises,
naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, lm, mamba
from repro_torch.nn.module import init_params, logical_specs

_FAMILIES = {
    "lm": (lm.lm_def, lm.forward, lm.decode_step, lm.lm_init_cache),
    "mamba": (mamba.mamba_lm_def, mamba.forward, mamba.decode_step,
              mamba.mamba_lm_init_cache),
    "griffin": (griffin.griffin_def, griffin.forward, griffin.decode_step,
                griffin.griffin_init_cache),
}
_LATER = {"encdec": "cross attention: models/encdec.py and "
          "seamless-m4t-large-v2"}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is ROADMAP Queue 1 "
            f"item 4 ({_LATER.get(cfg.family, 'not in the reference')}); "
            f"the port serves {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _family(self.cfg)

    @property
    def _fns(self):
        return _family(self.cfg)

    # ---- params ----
    def defs(self):
        pd = (torch.float32 if self.cfg.param_dtype == "float32"
              else torch.bfloat16)
        return self._fns[0](self.cfg, pd)

    def init(self, seed: int, device="cuda"):
        """Seeded random parameters on ``device`` (default the card)."""
        return init_params(self.defs(), seed, device)

    def specs(self):
        return logical_specs(self.defs())

    # ---- training loss (teacher-forced) ----
    def loss(self, params, batch, aux_weight: float = 0.01):
        logits, aux, _ = self._fns[1](params, batch["tokens"], self.cfg)
        logits = logits.to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[
            ..., 0]
        # z-loss keeps logits bounded (stability at scale)
        zl = 1e-4 * torch.square(torch.logsumexp(logits, dim=-1))
        return nll.mean() + zl.mean() + aux_weight * aux

    def forward(self, params, batch):
        return self._fns[1](params, batch["tokens"], self.cfg)

    # ---- serving ----
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        return self._fns[3](self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch):
        """Full forward over the prompt; returns last-position logits and
        the stacked (k, v) of every layer (None for the recurrent
        families)."""
        logits, _, kvs = self._fns[1](params, batch["tokens"], self.cfg,
                                      collect_kv=True)
        return logits[:, -1:], kvs

    def decode(self, params, cache, token, index):
        return self._fns[2](params, cache, token, index, self.cfg)


_REGISTRY: dict = {}
_LOADED = False  # importing one config module registers it alone


def register(cfg: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _LOADED:
        _load_all()
    return _REGISTRY[name]


def list_archs():
    if not _LOADED:
        _load_all()
    return sorted(_REGISTRY)


def _config_modules():
    import importlib
    import pkgutil

    import repro_torch.configs as cpkg
    for mod in pkgutil.iter_modules(cpkg.__path__):
        if mod.name != "base":
            yield importlib.import_module(f"repro_torch.configs.{mod.name}")


def _load_all():
    global _LOADED
    for _ in _config_modules():
        pass
    _LOADED = True


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for the arch with this registry name."""
    for m in _config_modules():
        if getattr(m, "CONFIG", None) is not None and m.CONFIG.name == name:
            return m.smoke_config()
    raise KeyError(name)


def build(name_or_cfg) -> Model:
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    return Model(cfg)
