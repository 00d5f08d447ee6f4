"""Data-parallel training over ``torch.distributed`` meshes (port of
``repro/distributed``): the logical-axis resolver and the compressed-DP
step. ``pipeline.py`` comes with the LM stack (ROADMAP A10)."""
