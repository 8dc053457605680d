from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig

__all__ = ["CLIP", "CLIPConfig"]
