"""Train D-FINE on a YOLO-format dataset:

    python -m dfine_tpu_torch.apps.train [config.yaml] [key.path=value ...]

The config defaults to ``config.yaml`` of the working directory; every
other argument is a dotted override (``model_name=s train.epochs=5``).
Training runs on the card (the first CUDA device) and raises without one;
``train.device`` is the JAX package's key and is not read here.
"""

from dfine_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
