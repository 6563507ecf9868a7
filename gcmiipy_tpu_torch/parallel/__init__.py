"""The latitude-ring decomposition over ``torch.distributed``."""
