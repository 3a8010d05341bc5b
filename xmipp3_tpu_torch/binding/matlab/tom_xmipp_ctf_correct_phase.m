function img_out = tom_xmipp_ctf_correct_phase(img, st, method, epsilon)
%TOM_XMIPP_CTF_CORRECT_PHASE correct the CTF phase of IMG given the model
%struct ST (from tom_xmipp_adjust_ctf): METHOD 'remove' zeroes small CTF
%values and sign-corrects the rest, 'leave' (default) keeps small values,
%'divide' divides by the CTF where |CTF| >= EPSILON.
%Replaces tom_xmipp_ctf_correct_phase.cpp.
if nargin < 4, epsilon = 0; end
if nargin < 3, method = 'leave'; end
out = xmipp_matlab_bridge('ctf_correct_phase', struct('img', img, ...
    'st', st, 'method', method, 'epsilon', epsilon));
img_out = out.img_out;
end
