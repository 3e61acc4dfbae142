"""Decoder model (GQA / MHA / MQA dense family) in plain PyTorch."""
