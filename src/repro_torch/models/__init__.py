"""The paper's MobileNetV2-VWW models (eval)."""
