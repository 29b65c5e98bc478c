"""Models of the port: the paper's MobileNetV2-VWW (`mobilenetv2`) and the
reference's language-model families (`rwkv6`, `transformer` with `moe`,
`rglru`, `vlm`, `whisper`), each reached through `families`."""
