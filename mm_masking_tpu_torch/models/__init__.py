from mm_masking_tpu_torch.models.convert import params_from_flax
from mm_masking_tpu_torch.models.policy import LearnICPWeightPolicy, PolicyOutput
from mm_masking_tpu_torch.models.unet import UNet

__all__ = ["LearnICPWeightPolicy", "PolicyOutput", "UNet", "params_from_flax"]
