from ray_tpu_torch.rllib.offline.json_io import JsonReader, JsonWriter

__all__ = ["JsonReader", "JsonWriter"]
