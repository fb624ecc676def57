// pctpu native IO: threaded batch point-cloud loading.
//
// The reference reads Velodyne scans with a per-point Python
// struct.iter_unpack loop (Final_Project/scripts/extract.py:23-47) — the ETL
// over 7481 KITTI frames is IO + parse bound. This library provides:
//   * read_f32: single-file raw float32 read (fread, no parsing)
//   * batch_read_f32: N files loaded concurrently by a pthread pool into one
//     preallocated arena — feeds the ETL/pipeline host side at disk speed
//   * voxel_count: standalone voxel-occupancy counter (hash map), the
//     host-side sizing pass for capacity planning before padding clouds
//
// Exposed via ctypes (pctpu/native/__init__.py); built with plain g++
// (no pybind11 dependency).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <pthread.h>
#include <unordered_set>
#include <cmath>

extern "C" {

// Read up to max_floats float32s from a binary file. Returns count read,
// or -1 on open failure.
long read_f32(const char* path, float* out, long max_floats) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long n = (long)fread(out, sizeof(float), (size_t)max_floats, f);
    fclose(f);
    return n;
}

struct BatchJob {
    const char** paths;
    float* arena;          // [n_files * stride_floats]
    long* counts;          // [n_files] floats read (or -1)
    long stride_floats;
    int n_files;
    int next;              // next file index to claim
    pthread_mutex_t lock;
};

static void* batch_worker(void* arg) {
    BatchJob* job = (BatchJob*)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        int i = job->next++;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->n_files) break;
        job->counts[i] = read_f32(job->paths[i],
                                  job->arena + (long)i * job->stride_floats,
                                  job->stride_floats);
    }
    return nullptr;
}

// Load n_files binary float32 files concurrently. Each file i lands at
// arena[i*stride_floats .. +counts[i]]. Returns 0 on success.
int batch_read_f32(const char** paths, int n_files, float* arena,
                   long stride_floats, long* counts, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_files) n_threads = n_files;
    BatchJob job;
    job.paths = paths;
    job.arena = arena;
    job.counts = counts;
    job.stride_floats = stride_floats;
    job.n_files = n_files;
    job.next = 0;
    pthread_mutex_init(&job.lock, nullptr);
    pthread_t threads[256];
    if (n_threads > 256) n_threads = 256;
    for (int t = 0; t < n_threads; ++t)
        pthread_create(&threads[t], nullptr, batch_worker, &job);
    for (int t = 0; t < n_threads; ++t)
        pthread_join(threads[t], nullptr);
    pthread_mutex_destroy(&job.lock);
    return 0;
}

// Count occupied voxels of an (n,3) float32 cloud at the given leaf size
// (the sizing pass for voxel_downsample capacity planning).
long voxel_count(const float* points, long n, float leaf) {
    if (n <= 0) return 0;
    float mn[3] = {points[0], points[1], points[2]};
    for (long i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d)
            if (points[3 * i + d] < mn[d]) mn[d] = points[3 * i + d];
    std::unordered_set<uint64_t> cells;
    cells.reserve((size_t)n);
    for (long i = 0; i < n; ++i) {
        uint64_t hx = (uint64_t)(int64_t)std::floor(
            (points[3 * i + 0] - mn[0]) / leaf);
        uint64_t hy = (uint64_t)(int64_t)std::floor(
            (points[3 * i + 1] - mn[1]) / leaf);
        uint64_t hz = (uint64_t)(int64_t)std::floor(
            (points[3 * i + 2] - mn[2]) / leaf);
        cells.insert((hx & 0x1FFFFF) | ((hy & 0x1FFFFF) << 21)
                     | ((hz & 0x1FFFFF) << 42));
    }
    return (long)cells.size();
}

}  // extern "C"
