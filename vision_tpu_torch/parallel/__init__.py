"""Pixel and sample sharding over torch.distributed (dist.py) and process
start-up and weak scaling (launch.py)."""
