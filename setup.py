from setuptools import find_packages, setup

setup(
    name="pevit_tpu",
    version="0.1.0",
    description="TPU-native parameter-efficient model adaptation for Vision Transformers (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests", "tools")),
    package_data={"pevit_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
                  "pevit_tpu_torch.native": ["image_ops.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pyyaml", "regex", "scikit-learn", "pillow"],
    entry_points={
        "console_scripts": [
            "pevit_linear_probe = pevit_tpu.commands.linear_probe:main",
            "pevit_finetune = pevit_tpu.commands.finetune:main",
            "pevit_kadaptation = pevit_tpu.commands.kronecker_adaptation_clip:main",
            "pevit_adapter = pevit_tpu.commands.adapter_clip:main",
            "pevit_lora = pevit_tpu.commands.lora_clip:main",
            "pevit_compacter = pevit_tpu.commands.compacter_clip:main",
            "pevit_zeroshot = pevit_tpu.commands.zeroshot:main",
            "pevit_prepare_submit = pevit_tpu.commands.prepare_submit:main",
        ]
    },
)
