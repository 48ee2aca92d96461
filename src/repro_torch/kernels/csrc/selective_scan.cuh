// Constants shared by the selective-scan forward (selective_scan.cu) and
// backward (selective_scan_bwd.cu).
#pragma once

namespace repro {
namespace scan {

constexpr int kSlots = 16;  // state slots per channel (N <= 16)
// Steps per chunk of the backward: under grad the forward writes the state
// entering every kChunk-th step, and the backward rebuilds a chunk's
// kChunk states in registers from it. The wrappers size their buffers
// through repro_selective_scan_sizes (selective_scan_bwd.cu). Measured on
// an NVIDIA H100 80GB HBM3 (700 W), backward at falcon-mamba-7b's / hymba-
// 1.5b's trained shapes: 8 steps 0.479 / 0.743 ms (162 registers), 16
// steps 0.887 / 1.085 ms (255), 4 steps 0.485 / 1.085 ms (128); the
// forward writing the checkpoints 0.082 / 0.129 ms at 8 against 0.077 /
// 0.123 at 16 (PERF.md, the scan backward's findings).
constexpr int kChunk = 8;

}  // namespace scan
}  // namespace repro
