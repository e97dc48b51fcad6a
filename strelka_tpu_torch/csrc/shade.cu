// Kernel K10: one bounce's BSDF phase (ops/integrator.py:trace_paths from
// bounce.bsdf to bounce.nee) in one pass, bit-equal to its plain version
// kernels/shade.py:shade_bsdf_plain on the card.
//
// The TPU package leaves this phase to XLA; the plain PyTorch code runs it as
// about 600 elementwise kernels a bounce (1,500 with the fibre lobes), each
// reading and writing the whole wavefront. Here one thread takes one lane
// and keeps everything in registers: the cutout's hash uniform
// (sampler.py:uniform_hash, the PCG hash in 32-bit words), the cutout
// decision, the emission, the media's indices of refraction, then
// bsdf_sample for the lane's own material type only (bsdf.cuh), the cutout's
// override, the absorbed test, depth 0's first event, the throughput and
// the specular flag.
//
// Bound on the H100: bytes. A lane reads about 180 bytes (16 words of
// material, 12 of frame, the direction, 4 uniforms, the 8-byte sample index,
// the path state and the flags) and writes about 60, once each, coalesced
// from the component-major [N] arrays the integrator holds; the fibre's
// ~1,500 f32 operations a lane stay under that time. Lanes that did not hit
// a surface read only their state and write it back unchanged, with the
// sample's fixed values (no event, zero vectors): every later reader of the
// sample masks it by `shade`.
//
// One instance per fibre variant (a template on it): a scene without hair
// materials carries no fibre code; the Chiang model and the Kajiya-Kay lobes
// are the other two. Built with -fmad=false (bsdf.cuh says why).

#include "bsdf.cuh"
#include "common.cuh"

namespace {

using namespace strelka_bsdf;

constexpr int kThreads = 128;

// The inputs, in the order of kernels/shade.py:IN_FIELDS: each an [n] array
// (f32 unless named: type and first_event int32, sample_idx int64, the
// flags bool)
enum : int {
    kType, kDiffuseX, kDiffuseY, kDiffuseZ, kMetallic, kRoughness, kSpecularLevel, kIor, kGlassX, kGlassY, kGlassZ,
    kOpacity, kEmissionX, kEmissionY, kEmissionZ, kThinWalled,
    kNormalX, kNormalY, kNormalZ, kTangentUX, kTangentUY, kTangentUZ, kTangentVX, kTangentVY, kTangentVZ,
    kGeomNormalX, kGeomNormalY, kGeomNormalZ,
    kDirectionX, kDirectionY, kDirectionZ, kXi0, kXi1, kXi2, kXi3, kSampleIdx, kInside, kHitSurface,
    kRadianceX, kRadianceY, kRadianceZ, kThroughputX, kThroughputY, kThroughputZ, kFirstEvent, kSpecularBounce,
    kInCount
};

// The outputs, in the order of kernels/shade.py:OUT_FIELDS
enum : int {
    kK2X, kK2Y, kK2Z, kPdf, kOverPdfX, kOverPdfY, kOverPdfZ, kEventType, kCut, kShade,
    kRadianceOutX, kRadianceOutY, kRadianceOutZ, kThroughputOutX, kThroughputOutY, kThroughputOutZ,
    kFirstEventOut, kSpecularBounceOut, kOutCount
};

using ShadePtrs = Lanes<kInCount, kOutCount>;

// ops/sampler.py:uniform_hash: the PCG hash of the sample index salted by
// the bounce, as an f32 in [0, 1)
__device__ __forceinline__ float uniform_hash(long long sample_idx, int depth) {
    const uint32_t salt = 0x9E3779B9u + 0x85EBCA6Bu * static_cast<uint32_t>(depth + 1);
    const uint32_t state = (static_cast<uint32_t>(sample_idx) ^ salt) * 747796405u + 2891336453u;
    uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
    word = (word >> 22) ^ word;
    return static_cast<float>(word) * 0x1p-32f;
}

// integrator.py:EventType
constexpr int kFirstAbsorb = 1, kFirstDiffuse = 2, kFirstSpecular = 3;

template <int kFibre>
__global__ void __launch_bounds__(kThreads) shade_bsdf_kernel(const ShadePtrs p, long long n, int depth) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    F3 radiance = p.ld3(kRadianceX, i);
    F3 throughput = p.ld3(kThroughputX, i);
    int first_event = p.ld<int>(kFirstEvent, i);
    bool specular_bounce = p.ld<bool>(kSpecularBounce, i);
    F3 k2 = splat(0.0f), over_pdf = splat(0.0f);
    float pdf = 0.0f;
    int event = kEventAbsorb;
    bool cut = false, shade = false;
    if (p.ld<bool>(kHitSurface, i)) {
        const F3 direction = p.ld3(kDirectionX, i);
        const float opacity = p.ld<float>(kOpacity, i);
        // the cutout decision comes first: a pass-through collects no emission
        cut = (opacity < 1.0f) & (uniform_hash(p.ld<long long>(kSampleIdx, i), depth) >= opacity);
        const F3 emission = p.ld3(kEmissionX, i);
        const bool emissive = !cut & ((emission.x != 0.0f) | (emission.y != 0.0f) | (emission.z != 0.0f));
        const bool front = dot(p.ld3(kGeomNormalX, i), direction) < 0.0f;
        if (emissive & front) radiance = radiance + throughput * emission;
        if (cut) {  // straight through as a specular transmission, in the same medium
            k2 = direction;
            over_pdf = splat(1.0f);
            event = kEventSpecularTransmission;
        } else {
            Material m;
            m.type = p.ld<int>(kType, i);
            m.diffuse = p.ld3(kDiffuseX, i);
            m.metallic = p.ld<float>(kMetallic, i);
            m.roughness = p.ld<float>(kRoughness, i);
            m.specular_level = p.ld<float>(kSpecularLevel, i);
            m.ior = p.ld<float>(kIor, i);
            m.glass = p.ld3(kGlassX, i);
            m.thin_walled = p.ld<bool>(kThinWalled, i);
            Frame fr;
            fr.normal = p.ld3(kNormalX, i);
            fr.tangent_u = p.ld3(kTangentUX, i);
            fr.tangent_v = p.ld3(kTangentVX, i);
            const float xi[4] = {p.ld<float>(kXi0, i), p.ld<float>(kXi1, i), p.ld<float>(kXi2, i),
                                 p.ld<float>(kXi3, i)};
            const bool inside = p.ld<bool>(kInside, i);
            const float ior1 = inside ? m.ior : 1.0f;
            const float ior2 = inside ? 1.0f : m.ior;
            const Sample s = bsdf_sample<kFibre>(m, fr, -direction, xi, ior1, ior2);
            k2 = s.k2;
            pdf = s.pdf;
            over_pdf = s.over_pdf;
            event = s.event;
        }
        const bool absorbed = event == kEventAbsorb;
        if (depth == 0) {
            if (absorbed) first_event = kFirstAbsorb;
            if ((event & kEventDiffuse) != 0) first_event = kFirstDiffuse;
            if ((event & kEventGlossy) != 0) first_event = kFirstSpecular;
        }
        if (absorbed) throughput = splat(0.0f);
        shade = !absorbed;
        if (shade) specular_bounce = (event & kEventSpecular) != 0;
    }
    p.st3(kK2X, i, k2);
    p.st(kPdf, i, pdf);
    p.st3(kOverPdfX, i, over_pdf);
    p.st(kEventType, i, event);
    p.st(kCut, i, cut);
    p.st(kShade, i, shade);
    p.st3(kRadianceOutX, i, radiance);
    p.st3(kThroughputOutX, i, throughput);
    p.st(kFirstEventOut, i, first_event);
    p.st(kSpecularBounceOut, i, specular_bounce);
}

}  // namespace

// in: kInCount device pointers, out: kOutCount (host arrays of pointers, in
// the orders above); variant: kNoFibre, kChiang or kKajiyaKay.
extern "C" int strelka_shade_bsdf(const void* const* in, void* const* out, long long n, int depth, int variant,
                                  void* stream) {
    if (n < 1 || variant < kNoFibre || variant > kKajiyaKay) return static_cast<int>(cudaErrorInvalidValue);
    const ShadePtrs p = make_lanes<kInCount, kOutCount>(in, out);
    const unsigned int blocks = strelka_blocks(n, kThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == kChiang)
        shade_bsdf_kernel<kChiang><<<blocks, kThreads, 0, s>>>(p, n, depth);
    else if (variant == kKajiyaKay)
        shade_bsdf_kernel<kKajiyaKay><<<blocks, kThreads, 0, s>>>(p, n, depth);
    else
        shade_bsdf_kernel<kNoFibre><<<blocks, kThreads, 0, s>>>(p, n, depth);
    STRELKA_RETURN_LAUNCH_STATUS();
}
