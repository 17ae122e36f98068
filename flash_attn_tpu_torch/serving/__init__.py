from flash_attn_tpu_torch.serving.server import ServingConfig, serve

__all__ = ["ServingConfig", "serve"]
