"""Asset IO: the glTF 2.0 / .glb reader and the Radiance .hdr reader and writer."""

from bpt_tpu_torch.io.gltf import GLTFModel, describe_gltf, load_gltf
from bpt_tpu_torch.io.hdr import read_hdr, write_hdr
