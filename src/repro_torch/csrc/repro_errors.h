// Return codes of the port's C launchers beyond cudaError_t, spelled out
// by repro_error_string (quantize.cu).
#pragma once

constexpr int kNoEncoder = 1000001;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 1000002;  // cuTensorMapEncodeTiled refused a map
