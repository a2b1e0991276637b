from .optimizer import OptConfig, abstract_opt_state, apply_update, global_norm, init_opt_state, lr_schedule

__all__ = ["OptConfig", "init_opt_state", "abstract_opt_state", "apply_update", "global_norm", "lr_schedule"]
