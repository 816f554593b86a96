/* Golden-fixture generator: runs the REFERENCE C implementation (built by
 * build_ref.sh) on deterministic inputs and dumps raw arrays, which
 * pack_goldens.py bundles into tests/goldens/c_goldens.npz.  The JAX
 * framework's tests then assert <=1e-4 parity against these outputs —
 * proving the accuracy budget against the actual C code rather than a
 * CPU re-render of the same Python pipeline.
 *
 * Recipes follow the reference's own tests:
 *   - afSTFT round-trip:  test/src/test__resources.c:27-103
 *   - ambi_bin block processing: test/src/test__examples.c:29-107
 *   - decoder matrix: examples/src/ambi_bin/ambi_bin.c:283-330 (initCodec)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#include "saf.h"
#include "ambi_bin.h"

#define HOPSIZE 128
#define NBANDS  133  /* hybrid bands for hop 128: hop+5 */

static FILE* manifest;
static const char* outdir;

static void dump(const char* name, const void* data, size_t n_elem,
                 const char* dtype, const char* shape)
{
    char path[512];
    size_t esz = strcmp(dtype, "c8") == 0 ? 8 : 4;
    snprintf(path, sizeof(path), "%s/%s.bin", outdir, name);
    FILE* f = fopen(path, "wb");
    if (!f) { perror(path); exit(1); }
    fwrite(data, esz, n_elem, f);
    fclose(f);
    fprintf(manifest, "%s %s %s\n", name, dtype, shape);
}

/* deterministic noise in [-1, 1) — same LCG replicated in pack_goldens.py */
static unsigned int lcg_state = 1234567u;
static float lcg_noise(void)
{
    lcg_state = lcg_state * 1664525u + 1013904223u;
    return (float)(lcg_state >> 8) / 8388608.0f - 1.0f;
}

/* -------------------------------------------------------------------- */
static void golden_sh(void)
{
    /* getSHreal order 7 on an 18x9 az/incl grid */
    const int order = 7, nsh = (order + 1) * (order + 1);
    const int naz = 18, nin = 9, nd = naz * nin;
    float* dirs_rad = malloc1d(nd * 2 * sizeof(float));
    float* dirs_deg = malloc1d(nd * 2 * sizeof(float));
    int i, j, k = 0;
    for (i = 0; i < naz; i++) {
        for (j = 0; j < nin; j++, k++) {
            float az_deg = -180.0f + 20.0f * i;
            float incl_deg = 10.0f + 20.0f * j;
            dirs_rad[2 * k] = az_deg * (float)M_PI / 180.0f;
            dirs_rad[2 * k + 1] = incl_deg * (float)M_PI / 180.0f;
            dirs_deg[2 * k] = az_deg;
            dirs_deg[2 * k + 1] = 90.0f - incl_deg;  /* elevation */
        }
    }
    float* Y = malloc1d(nsh * nd * sizeof(float));
    getSHreal(order, dirs_rad, nd, Y);
    dump("sh_dirs_rad", dirs_rad, nd * 2, "f4", "162,2");
    dump("sh_Y_o7", Y, nsh * nd, "f4", "64,162");

    /* getRSH order 4 (the encoding weights used by test__examples.c) */
    const int o4 = 4, nsh4 = 25;
    float* Y4 = malloc1d(nsh4 * nd * sizeof(float));
    getRSH(o4, dirs_deg, nd, Y4);
    dump("sh_dirs_deg", dirs_deg, nd * 2, "f4", "162,2");
    dump("sh_RSH_o4", Y4, nsh4 * nd, "f4", "25,162");

    /* real SH rotation matrix, order 4, ypr = (30, -10, 5) deg */
    float R[3][3];
    yawPitchRoll2Rzyx(30.0f * (float)M_PI / 180.0f,
                      -10.0f * (float)M_PI / 180.0f,
                      5.0f * (float)M_PI / 180.0f, 0, R);
    float* Mrot = malloc1d(nsh4 * nsh4 * sizeof(float));
    getSHrotMtxReal(R, Mrot, o4);
    dump("sh_R3", (float*)R, 9, "f4", "3,3");
    dump("sh_rot_o4", Mrot, nsh4 * nsh4, "f4", "25,25");

    free(dirs_rad); free(dirs_deg); free(Y); free(Y4); free(Mrot);
}

/* -------------------------------------------------------------------- */
static void golden_afstft(void)
{
    const int fs = 48000, framesize = 512, nCH = 4, nFrames = 8;
    const int nHops = framesize / HOPSIZE;
    const int sigLen = nFrames * framesize;
    int frame, ch, band, i;
    void* h;
    float** insig = (float**)malloc2d(nCH, sigLen, sizeof(float));
    float** outsig = (float**)malloc2d(nCH, sigLen, sizeof(float));
    float** inframe = (float**)malloc2d(nCH, framesize, sizeof(float));
    float** outframe = (float**)malloc2d(nCH, framesize, sizeof(float));
    for (ch = 0; ch < nCH; ch++)
        for (i = 0; i < sigLen; i++)
            insig[ch][i] = lcg_noise();

    afSTFT_create(&h, nCH, nCH, HOPSIZE, 0, 1, AFSTFT_BANDS_CH_TIME);
    int nBands = afSTFT_getNBands(h);
    int procDelay = afSTFT_getProcDelay(h);
    float* cf = malloc1d(nBands * sizeof(float));
    afSTFT_getCentreFreqs(h, (float)fs, nBands, cf);

    float_complex*** spec =
        (float_complex***)malloc3d(nBands, nCH, nHops, sizeof(float_complex));
    float_complex* allspec =
        malloc1d(nFrames * nBands * nCH * nHops * sizeof(float_complex));

    for (frame = 0; frame < nFrames; frame++) {
        for (ch = 0; ch < nCH; ch++)
            memcpy(inframe[ch], &insig[ch][frame * framesize],
                   framesize * sizeof(float));
        afSTFT_forward(h, inframe, framesize, spec);
        memcpy(&allspec[frame * nBands * nCH * nHops], FLATTEN3D(spec),
               nBands * nCH * nHops * sizeof(float_complex));
        afSTFT_backward(h, spec, framesize, outframe);
        for (ch = 0; ch < nCH; ch++)
            memcpy(&outsig[ch][frame * framesize], outframe[ch],
                   framesize * sizeof(float));
    }
    float pd = (float)procDelay;
    dump("afstft_in", FLATTEN2D(insig), nCH * sigLen, "f4", "4,4096");
    dump("afstft_spec", allspec, nFrames * nBands * nCH * nHops, "c8",
         "8,133,4,4");
    dump("afstft_out", FLATTEN2D(outsig), nCH * sigLen, "f4", "4,4096");
    dump("afstft_centre_freqs", cf, nBands, "f4", "133");
    dump("afstft_proc_delay", &pd, 1, "f4", "1");

    afSTFT_destroy(&h);
    free(insig); free(outsig); free(inframe); free(outframe);
    free(spec); free(allspec); free(cf);
}

/* -------------------------------------------------------------------- */
static void golden_decoder_mtx(void)
{
    /* the initCodec design chain (ambi_bin.c:249-330) at order 3, MagLS,
     * maxRE on, diffuse-matching off, diffuse-field EQ preproc */
    const int order = 3, nsh = (order + 1) * (order + 1);
    const int N = __default_N_hrir_dirs, len = __default_hrir_len;
    const int fs = __default_hrir_fs;
    float* hrirs = malloc1d(N * NUM_EARS * len * sizeof(float));
    float* dirs = malloc1d(N * 2 * sizeof(float));
    memcpy(hrirs, (const float*)__default_hrirs,
           N * NUM_EARS * len * sizeof(float));
    memcpy(dirs, (const float*)__default_hrir_dirs_deg, N * 2 * sizeof(float));

    float* itds = malloc1d(N * sizeof(float));
    estimateITDs(hrirs, N, len, fs, itds);
    dump("dec_itds", itds, N, "f4", "836");

    float_complex* hrtf_fb =
        malloc1d(NBANDS * NUM_EARS * N * sizeof(float_complex));
    HRIRs2HRTFs_afSTFT(hrirs, N, len, HOPSIZE, 0, 1, hrtf_fb);
    dump("dec_hrtf_fb_raw", hrtf_fb, NBANDS * NUM_EARS * N, "c8", "133,2,836");

    float* weights = malloc1d(N * sizeof(float));
    getVoronoiWeights(dirs, N, 0, weights);
    dump("dec_voronoi_w", weights, N, "f4", "836");

    /* centre freqs for hop 128 hybrid mode */
    void* h;
    afSTFT_create(&h, 1, 1, HOPSIZE, 0, 1, AFSTFT_BANDS_CH_TIME);
    float* cf = malloc1d(NBANDS * sizeof(float));
    afSTFT_getCentreFreqs(h, (float)fs, NBANDS, cf);
    afSTFT_destroy(&h);

    diffuseFieldEqualiseHRTFs(N, itds, cf, NBANDS, weights, 1, 0, hrtf_fb);
    dump("dec_hrtf_fb_eq", hrtf_fb, NBANDS * NUM_EARS * N, "c8", "133,2,836");

    float_complex* decMtx =
        calloc1d(NBANDS * NUM_EARS * nsh, sizeof(float_complex));
    getBinauralAmbiDecoderMtx(hrtf_fb, dirs, N, NBANDS, BINAURAL_DECODER_MAGLS,
                              order, cf, itds, weights, 0, 1, decMtx);
    dump("dec_magls_o3", decMtx, NBANDS * NUM_EARS * nsh, "c8", "133,2,16");

    /* also the plain LS decoder for the same setup */
    float_complex* decLS =
        calloc1d(NBANDS * NUM_EARS * nsh, sizeof(float_complex));
    getBinauralAmbiDecoderMtx(hrtf_fb, dirs, N, NBANDS, BINAURAL_DECODER_LS,
                              order, cf, itds, weights, 0, 1, decLS);
    dump("dec_ls_o3", decLS, NBANDS * NUM_EARS * nsh, "c8", "133,2,16");

    free(hrirs); free(dirs); free(itds); free(hrtf_fb); free(weights);
    free(cf); free(decMtx); free(decLS);
}

/* -------------------------------------------------------------------- */
static void golden_ambi_bin_e2e(void)
{
    /* test__examples.c:29-107 recipe, deterministic input, order 4 MagLS
     * (the create() defaults) + NORM_N3D + rotation yaw 180 */
    const int order = 4, fs = 48000;
    const int nSH = (order + 1) * (order + 1);
    int i, ch, frame;
    void* h;
    ambi_bin_create(&h);
    ambi_bin_setNormType(h, NORM_N3D);
    ambi_bin_setInputOrderPreset(h, (SH_ORDERS)order);
    ambi_bin_init(h, fs);
    ambi_bin_setEnableRotation(h, 1);
    ambi_bin_setYaw(h, 180.0f);
    ambi_bin_initCodec(h);

    const int framesize = ambi_bin_getFrameSize();
    const int nFrames = 64;
    const int sigLen = nFrames * framesize;
    float* inSig = malloc1d(sigLen * sizeof(float));
    for (i = 0; i < sigLen; i++)
        inSig[i] = lcg_noise();

    /* encode hard-right */
    float direction_deg[2] = { -90.0f, 0.0f };
    float* y = malloc1d(nSH * sizeof(float));
    getRSH(order, direction_deg, 1, y);
    float** shSig = (float**)malloc2d(nSH, sigLen, sizeof(float));
    for (ch = 0; ch < nSH; ch++)
        for (i = 0; i < sigLen; i++)
            shSig[ch][i] = y[ch] * inSig[i];

    float** binSig = (float**)calloc2d(NUM_EARS, sigLen, sizeof(float));
    float** inFr = (float**)malloc1d(nSH * sizeof(float*));
    float** outFr = (float**)malloc1d(NUM_EARS * sizeof(float*));
    for (frame = 0; frame < nFrames; frame++) {
        for (ch = 0; ch < nSH; ch++)
            inFr[ch] = &shSig[ch][frame * framesize];
        for (ch = 0; ch < NUM_EARS; ch++)
            outFr[ch] = &binSig[ch][frame * framesize];
        ambi_bin_process(h, (const float* const*)inFr, outFr, nSH, NUM_EARS,
                         framesize);
    }

    dump("ambi_bin_in_mono", inSig, sigLen, "f4", "8192");
    dump("ambi_bin_enc_y", y, nSH, "f4", "25");
    dump("ambi_bin_out", FLATTEN2D(binSig), NUM_EARS * sigLen, "f4", "2,8192");

    ambi_bin_destroy(&h);
    free(inSig); free(y); free(shSig); free(binSig); free(inFr); free(outFr);
}

/* -------------------------------------------------------------------- */
int main(int argc, char** argv)
{
    if (argc != 2) { fprintf(stderr, "usage: %s <outdir>\n", argv[0]); return 1; }
    outdir = argv[1];
    char mpath[512];
    snprintf(mpath, sizeof(mpath), "%s/manifest.txt", outdir);
    manifest = fopen(mpath, "a");  /* append like the other generators; run_goldens.sh clears it */
    if (!manifest) { perror(mpath); return 1; }

    golden_sh();
    printf("sh goldens done\n");
    golden_afstft();
    printf("afstft goldens done\n");
    golden_decoder_mtx();
    printf("decoder goldens done\n");
    golden_ambi_bin_e2e();
    printf("ambi_bin e2e goldens done\n");

    fclose(manifest);
    return 0;
}
