"""In-flash image encryption (paper §6.2) on the PyTorch port: bulk XOR
with a key.

Stores image bitplanes and the keystream as aligned MLC shared pages
through a :class:`repro_torch.api.ComputeSession` and encrypts inside the
flash array (one SBR-based XOR sense per page pair), then decrypts the same
way and checks the round trip against the image, bit for bit.

    PYTHONPATH=src python examples/torch_image_encryption.py               # the card
    PYTHONPATH=src python examples/torch_image_encryption.py --device cpu  # 1 kB pages
"""
import argparse

import numpy as np

from repro_torch.api import ComputeSession
from repro_torch.flash import SSDConfig, image_encryption, speedup_table

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "kernels' plain versions at 1 kB pages)")
args = ap.parse_args()
config = SSDConfig(page_kb=1) if args.device == "cpu" else None

rng = np.random.default_rng(7)
sess = ComputeSession(args.device, config=config, seed=7)

# one 8-bit grayscale image -> exactly one page of bits (128x128 at 16 kB)
side = int(np.sqrt(sess.device.config.page_bits // 8))
img = rng.integers(0, 256, (side, side), dtype=np.uint8)
bits = np.unpackbits(img.reshape(-1))
key = rng.integers(0, 2, bits.shape[0], dtype=np.uint8)

img_v, key_v = sess.write_pair("img", bits, "key", key)
cipher = sess.materialize(img_v ^ key_v, unpacked=True,
                          to_host=False).cpu().numpy()
assert not np.array_equal(cipher, bits), "ciphertext must differ from plaintext"

# decrypt: XOR the ciphertext with the key again (write back, sense again)
sess2 = ComputeSession(args.device, config=config, seed=8)
cipher_v, key_v2 = sess2.write_pair("cipher", cipher, "key", key)
plain = sess2.materialize(cipher_v ^ key_v2, unpacked=True,
                          to_host=False).cpu().numpy()
np.testing.assert_array_equal(plain, bits)
rec = np.packbits(plain).reshape(side, side)
np.testing.assert_array_equal(rec, img)
print(f"round-trip in-flash XOR encryption of a {side}x{side} image: "
      "bit-exact OK")
print(f"simulated die time: {sess.ledger.makespan_us():.0f} us "
      f"(serial {sess.ledger.serial_us():.0f} us), "
      f"energy {sess.ledger.energy_uj:.0f} uJ, "
      f"plan cache {sess.stats()['plan_cache']}")

s = speedup_table(image_encryption(5000))["speedup_vs"]
print(f"\nprojected speedups at 5k images (Fig 10b): "
      f"OSC {s['osc']:.1f}x  ISC {s['isc']:.1f}x  ParaBit {s['parabit']:.2f}x  "
      f"Flash-Cosmos {s['flashcosmos']:.2f}x")
