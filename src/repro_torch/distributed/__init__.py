"""Logical-axis rules for ``torch.distributed`` meshes."""
