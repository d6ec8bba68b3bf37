import sys

from distributed_kfac_pytorch_tpu_torch.autotune.driver import main

if __name__ == '__main__':
    sys.exit(main())
