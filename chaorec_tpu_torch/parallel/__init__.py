"""Multi-device training and ranking over torch.distributed (``mesh.py``)."""
