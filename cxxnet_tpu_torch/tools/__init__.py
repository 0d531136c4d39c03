"""Command-line tools of the port (counterparts of the repo-root
``tools/``): ``python -m cxxnet_tpu_torch.tools.ckpt_verify``."""
