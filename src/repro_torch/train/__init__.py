"""Training: Adam with decoupled weight decay (`optimizer`), int8
gradient compression with error feedback (`grad_compression`) and the
train step with microbatch accumulation (`train_step`), on one device
(the port of `repro/train/`)."""
