"""Instruction-stream backend: per-PE stream export + standalone
interpreter + bit-exact cross-validation (ROADMAP hardware-facing leg).

    from repro_torch.isa import export_streams, load_stream, interpret

    ck = Toolchain().compile(spec)
    export_streams(ck, "out/gemm")        # instructions.csv / kernel.asm /
                                          # stream_manifest.json
    stream = load_stream("out/gemm")
    final = interpret(stream, init_banks, ck.invocations, ck.mapped_iters)

    from repro_torch.isa import cross_validate
    cross_validate(ck, seeds=(0, 1))      # interpreter ≡ simulate(), bitwise

The exported artifacts are byte-deterministic (the repo's standing
contract: two cold exports of the same kernel ``cmp`` equal), and the
interpreter shares no code with the torch simulator — it is the flow's
independent second oracle (``MORPHER_XVAL=1`` enables it inside verify).
"""
from .encode import (ASM_NAME, CSV_NAME, MANIFEST_NAME, STREAM_FORMAT,
                     encode_kernel, export_streams, to_asm, to_csv,
                     to_manifest_json)
from .interp import (InstructionStream, StreamError, interpret, load_stream,
                     parse_stream)
from .xval import cross_validate, cross_validate_dir, stream_for

__all__ = [
    "ASM_NAME", "CSV_NAME", "MANIFEST_NAME", "STREAM_FORMAT",
    "InstructionStream", "StreamError",
    "cross_validate", "cross_validate_dir", "encode_kernel",
    "export_streams", "interpret", "load_stream", "parse_stream",
    "stream_for", "to_asm", "to_csv", "to_manifest_json",
]
