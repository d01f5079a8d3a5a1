// Part of the CUDA mock: see cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
