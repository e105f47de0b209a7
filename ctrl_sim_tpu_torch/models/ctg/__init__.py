"""CTG++ diffusion baseline: DiT trunk, Gaussian diffusion, RTG model."""
