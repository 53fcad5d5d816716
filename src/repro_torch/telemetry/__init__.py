from repro_torch.telemetry import hlo_cost, roofline, spans
__all__ = ["hlo_cost", "roofline", "spans"]
