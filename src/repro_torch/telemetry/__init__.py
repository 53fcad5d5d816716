from repro_torch.telemetry import hlo_cost, roofline
__all__ = ["hlo_cost", "roofline"]
