// One launcher for the port's thread-block-cluster kernels (the single-pass
// attention walks and the bit-sliced LUT GEMMs).
#pragma once

#include <cuda_runtime.h>

// Launch ``kernel`` on ``grid`` in clusters of C blocks along x, ``threads``
// threads a block and ``smem`` bytes of dynamic shared memory (the kernel's
// limit raised first where that is above 48 KB, and clusters above the
// portable 8 allowed first where C is). With ``clusters`` set, write
// cudaOccupancyMaxActiveClusters for that configuration there instead of
// launching.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int C, int smem,
                           cudaStream_t stream, int* clusters, Args... args) {
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    if (C > 8) {                              // above the portable cluster size
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (clusters) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}
