from .lpips import lpips_distance, make_lpips
from .metrics import mse, psnr, ssim, ssim_metric
from .render_image import ImageRenderer, default_pack, light_state_for_novel_pose

__all__ = ["ImageRenderer", "default_pack", "light_state_for_novel_pose", "lpips_distance",
           "make_lpips", "mse", "psnr", "ssim", "ssim_metric"]
