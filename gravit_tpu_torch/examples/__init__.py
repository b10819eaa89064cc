"""The reference's apps on the port's api, counterparts of examples/*.py.

Run one on the card as a module from the repository's root, for example
    python -m gravit_tpu_torch.examples.simple_app -image
Every app takes `-device cpu` to run the plain PyTorch path instead.
Importing an app has no side effect: its command line runs under
`if __name__ == "__main__"`.
"""
