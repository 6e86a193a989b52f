from demfi_torch.infer.engine import InferenceEngine, WindowResult

__all__ = ["InferenceEngine", "WindowResult"]
