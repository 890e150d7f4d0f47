"""The data layer (port of efficientvlm_tpu/data/): on the host, text
normalisation, the tokenizer, JSONL streams, MLM masking, PIL transforms,
the native JPEG decoder, the task datasets and the loaders (numpy and PIL,
no torch); on the device, image preprocessing (device_pipeline)."""
