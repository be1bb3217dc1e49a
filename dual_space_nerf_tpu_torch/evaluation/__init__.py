from .metrics import mse, psnr, ssim, ssim_metric
from .render_image import ImageRenderer, light_state_for_novel_pose

__all__ = ["ImageRenderer", "light_state_for_novel_pose", "mse", "psnr", "ssim", "ssim_metric"]
