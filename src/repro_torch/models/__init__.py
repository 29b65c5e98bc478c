"""Models of the port: the paper's MobileNetV2-VWW (`mobilenetv2`) and the
RWKV-6 language model (`rwkv6`, through `families`)."""
